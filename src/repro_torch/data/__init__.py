"""Data substrate: tokenizer, synthetic QA corpus and MusicGen's codebook
delay pattern (numpy-only copies of ``repro.data``'s modules)."""

from repro_torch.data.qa_dataset import (CATEGORIES, QAPair, TestQuery,
                                         build_corpus, build_test_queries,
                                         paraphrase)
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID, HashTokenizer

__all__ = ["HashTokenizer", "PAD_ID", "BOS_ID", "EOS_ID", "CATEGORIES",
           "QAPair", "TestQuery", "build_corpus", "build_test_queries",
           "paraphrase"]
