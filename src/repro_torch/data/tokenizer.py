"""Deterministic offline tokenizer (no network, no learned vocab files).

A word-level signed-hash tokenizer: whitespace/punctuation split, each
token hashed into a fixed id space with a reserved special-token region.
Round-trippable enough for the serving loop (responses are stored as token
ids in the cache slab and detokenized via an id->string side table built
as tokens are first seen — the Redis-value analogue of the paper storing
raw response strings).
"""
from __future__ import annotations

import hashlib
import re

_SPLIT = re.compile(r"\w+|[^\w\s]")

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
N_SPECIAL = 8


class HashTokenizer:
    """Stateless hashing encoder + stateful (per-instance) decoder table."""

    def __init__(self, vocab_size: int = 32768):
        assert vocab_size > N_SPECIAL * 2
        self.vocab_size = vocab_size
        self._id2str: dict[int, str] = {PAD_ID: "", BOS_ID: "<s>",
                                        EOS_ID: "</s>", UNK_ID: "<unk>"}

    def token_id(self, word: str) -> int:
        h = hashlib.blake2s(word.lower().encode(), digest_size=8).digest()
        tid = N_SPECIAL + int.from_bytes(h, "little") % (self.vocab_size - N_SPECIAL)
        return tid

    def encode(self, text: str, *, bos: bool = True, eos: bool = False,
               max_len: int | None = None) -> list[int]:
        ids = [BOS_ID] if bos else []
        for w in _SPLIT.findall(text):
            tid = self.token_id(w)
            self._id2str.setdefault(tid, w.lower())
            ids.append(tid)
        if eos:
            ids.append(EOS_ID)
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def decode(self, ids) -> str:
        words = []
        for t in ids:
            t = int(t)
            if t in (PAD_ID, BOS_ID):
                continue
            if t == EOS_ID:
                break
            words.append(self._id2str.get(t, "<unk>"))
        return " ".join(words)

    def encode_batch(self, texts, max_len: int):
        import numpy as np
        out = np.full((len(texts), max_len), PAD_ID, dtype=np.int32)
        lens = np.zeros((len(texts),), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t, max_len=max_len)
            out[i, :len(ids)] = ids
            lens[i] = len(ids)
        return out, lens
