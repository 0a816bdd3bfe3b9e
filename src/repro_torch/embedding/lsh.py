"""SimHash LSH for host-side near-duplicate detection (DESIGN.md §12.3),
PyTorch port of ``repro.embedding.lsh`` (numpy, the same code).

The scheduler's in-flight coalescing dedups by normalized query *text*; a
paraphrase arriving one millisecond behind its leader misses the window
and pays its own lookup/backend call. This module is the cheap host-side
bridge to *embedding-similarity* coalescing: random-hyperplane signatures
(Charikar 2002) bucket unit vectors so that the collision probability per
bit is ``1 - θ/π`` — near-duplicates collide in some table with high
probability, unrelated queries rarely do.

The LSH is a **prefilter only**: a bucket collision nominates candidates,
and the caller must verify true cosine similarity against its threshold
before coalescing (the scheduler does — ``_similar_leader``). That
two-step shape is what makes the guarantee one-sided: a missed collision
just forfeits a dedup (correctness unaffected), while a false collision
is caught by the exact cosine check, so distinct-meaning queries can
never share a leader.

Multiple short-signature tables (default 6 tables x 10 bits) trade a few
hundred bytes of state for recall: P[collide in >=1 table] =
``1 - (1 - p^bits)^tables``, ~0.97 for cosine 0.9 pairs at the defaults,
while cosine 0.5 pairs collide in <2% of submissions — and those few are
rejected by the verification step anyway.
"""
from __future__ import annotations

import numpy as np


class SimHashLSH:
    """Random-hyperplane signatures over unit vectors. Deterministic for a
    given (dim, tables, bits, seed) — two processes agree on buckets."""

    def __init__(self, dim: int, *, n_tables: int = 6, n_bits: int = 10,
                 seed: int = 1234):
        if n_tables < 1 or n_bits < 1 or n_bits > 62:
            raise ValueError("need n_tables >= 1 and 1 <= n_bits <= 62")
        rng = np.random.default_rng(seed)
        # (T, bits, dim) hyperplane normals; one sign pattern per table
        self.planes = rng.standard_normal(
            (n_tables, n_bits, dim)).astype(np.float32)
        self.n_tables = n_tables
        self.n_bits = n_bits
        self._weights = (1 << np.arange(n_bits, dtype=np.int64))

    def buckets(self, vec: np.ndarray) -> tuple[int, ...]:
        """One packed bucket id per table for a single vector."""
        bits = (self.planes @ np.asarray(vec, dtype=np.float32)) > 0.0
        return tuple(int(b) for b in (bits @ self._weights))


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Exact cosine for the verification step (safe on zero vectors)."""
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))
