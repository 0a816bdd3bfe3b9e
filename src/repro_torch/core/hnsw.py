"""Paper-faithful HNSW index (Malkov & Yashunin 2018), numpy, on the host
(PyTorch port of ``repro.core.hnsw``, copied: one seed gives the
reference's levels, links, entry point and search results bit for bit).

The paper's deployment searches the cache with hnswlib-node. HNSW is a
pointer-chasing multi-layer proximity graph, the *reference* algorithm for
the reproduction baseline. It does not map onto the GPU's tensor cores
either, so the card's path replaces it with exact blocked scoring / IVF;
this module exists so the reproduction measures the paper's own data
structure, and so its agreement with the exact cosine top-k can be read
(``chip_smoke.py``'s ``tools`` phase).

Implements: level sampling (exponential), greedy descent through upper
layers, ef-bounded best-first search at layer 0, and bidirectional link
insertion with degree pruning, the core of the published algorithm.
Distances are cosine (via normalized dot product), matching the paper.
One departure: ``search_batch`` searches each query once, where the
reference searches it twice (once for the ids, once for the sims);
``search`` draws no random numbers, so the results are the same.
"""
from __future__ import annotations

import heapq
import math

import numpy as np


class HNSWIndex:
    """Hierarchical Navigable Small World graph over normalized vectors."""

    def __init__(self, dim: int, max_elements: int = 100_000, m: int = 16,
                 ef_construction: int = 200, ef_search: int = 64,
                 seed: int = 0):
        self.dim = dim
        self.max_elements = max_elements
        self.m = m                      # max links per node per layer (2m at layer 0)
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self._rng = np.random.default_rng(seed)
        self._level_mult = 1.0 / math.log(m)

        self.vectors = np.zeros((max_elements, dim), dtype=np.float32)
        self.levels: list[int] = []
        # links[level][node] -> list[int]
        self.links: list[dict[int, list[int]]] = []
        self.entry_point: int | None = None
        self.count = 0

    # -- distances ---------------------------------------------------------
    def _sim(self, q: np.ndarray, idx) -> np.ndarray:
        return self.vectors[idx] @ q

    # -- construction ------------------------------------------------------
    def _random_level(self) -> int:
        return int(-math.log(max(self._rng.random(), 1e-12)) * self._level_mult)

    def add(self, vec: np.ndarray) -> int:
        if self.count >= self.max_elements:
            # dynamic resize, as the paper's system does when the index fills
            self._resize(self.max_elements * 2)
        vec = np.asarray(vec, dtype=np.float32)
        vec = vec / max(np.linalg.norm(vec), 1e-12)
        node = self.count
        self.vectors[node] = vec
        level = self._random_level()
        self.levels.append(level)
        while len(self.links) <= level:
            self.links.append({})
        for lv in range(level + 1):
            self.links[lv][node] = []
        self.count += 1

        if self.entry_point is None:
            self.entry_point = node
            return node

        ep = self.entry_point
        top = self.levels[self.entry_point]
        # greedy descend through layers above the node's level
        for lv in range(top, level, -1):
            ep = self._greedy_step(vec, ep, lv)
        # insert links from level min(level, top) down to 0
        for lv in range(min(level, top), -1, -1):
            cands = self._search_layer(vec, [ep], lv, self.ef_construction)
            m_max = self.m * 2 if lv == 0 else self.m
            neigh = self._select_neighbors(cands, self.m)
            self.links[lv][node] = [n for _, n in neigh]
            for _, n in neigh:
                lst = self.links[lv][n]
                lst.append(node)
                if len(lst) > m_max:
                    # prune to the closest m_max
                    sims = self._sim(self.vectors[n], lst)
                    order = np.argsort(-sims)[:m_max]
                    self.links[lv][n] = [lst[i] for i in order]
            ep = cands[0][1] if cands else ep
        if level > self.levels[self.entry_point]:
            self.entry_point = node
        return node

    def _resize(self, new_max: int) -> None:
        grown = np.zeros((new_max, self.dim), dtype=np.float32)
        grown[: self.count] = self.vectors[: self.count]
        self.vectors = grown
        self.max_elements = new_max

    def _greedy_step(self, q: np.ndarray, ep: int, level: int) -> int:
        cur, cur_sim = ep, float(self.vectors[ep] @ q)
        improved = True
        while improved:
            improved = False
            for n in self.links[level].get(cur, ()):
                s = float(self.vectors[n] @ q)
                if s > cur_sim:
                    cur, cur_sim, improved = n, s, True
        return cur

    def _search_layer(self, q, eps, level, ef):
        """Best-first search; returns [(sim, node)] sorted desc, <= ef items."""
        visited = set(eps)
        cand = [(-float(self.vectors[e] @ q), e) for e in eps]  # max-heap via neg
        heapq.heapify(cand)
        best = [(float(self.vectors[e] @ q), e) for e in eps]   # min-heap of sims
        heapq.heapify(best)
        while cand:
            neg_s, node = heapq.heappop(cand)
            if best and -neg_s < best[0][0] and len(best) >= ef:
                break
            for n in self.links[level].get(node, ()):
                if n in visited:
                    continue
                visited.add(n)
                s = float(self.vectors[n] @ q)
                if len(best) < ef or s > best[0][0]:
                    heapq.heappush(cand, (-s, n))
                    heapq.heappush(best, (s, n))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted(best, reverse=True)

    @staticmethod
    def _select_neighbors(cands, m):
        return cands[:m]

    # -- search ------------------------------------------------------------
    def search(self, q: np.ndarray, k: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Top-k (indices, cosine sims) for one query. Empty -> (-1, -inf)."""
        if self.entry_point is None or self.count == 0:
            return (np.full(k, -1, dtype=np.int64), np.full(k, -np.inf, np.float32))
        q = np.asarray(q, dtype=np.float32)
        q = q / max(np.linalg.norm(q), 1e-12)
        ep = self.entry_point
        for lv in range(self.levels[self.entry_point], 0, -1):
            ep = self._greedy_step(q, ep, lv)
        res = self._search_layer(q, [ep], 0, max(self.ef_search, k))[:k]
        idx = np.full(k, -1, dtype=np.int64)
        sims = np.full(k, -np.inf, dtype=np.float32)
        for i, (s, n) in enumerate(res):
            idx[i], sims[i] = n, s
        return idx, sims

    def search_batch(self, qs: np.ndarray, k: int = 1):
        res = [self.search(q, k) for q in qs]
        return (np.stack([idx for idx, _ in res]),
                np.stack([sims for _, sims in res]))
