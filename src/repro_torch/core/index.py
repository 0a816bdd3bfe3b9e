"""Indexes over the cache slab (paper §2.4), PyTorch port of
``repro.core.index``.

* ``ExactIndex``: brute-force cosine top-k, exact (recall 1.0) and
  stateless, so its index state is an empty dataclass. On CUDA tensors the
  search runs the hand-written cosine top-k kernels (shared mask, per-row
  interval or dense per-row mask); on CPU tensors their plain versions.
* ``IVFIndex``: an inverted file, the repo's stand-in for the paper's HNSW
  graph. ``refit`` runs k-means over the live keys and keeps each
  centroid's nearest members in a padded (C, bucket_cap) table; ``absorb``
  appends fresh rows to their nearest centroid's bucket between refits;
  ``search`` probes the ``nprobe`` best centroids (the cosine kernel, the
  centroids as its slab) and scores the probed members with the IVF
  candidate kernel, which never builds the (B, M, d) tensor of gathered
  rows. All visibility is folded into the candidate ids by
  ``IVFIndex.candidates``, so the kernel and its plain version share one
  contract.

Both follow the ``repro_torch.core.runtime.Index`` protocol. ``jax.random``
has no torch twin: the IVF init centroids come from a CPU
``torch.Generator`` seeded 0, and ``refit`` draws its k-means seeds with
the caller's CPU generator, so the card and the CPU draw the same rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.similarity import (NEG_INF, interval_visibility,
                                         l2_normalize, masked_topk)
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.kernels import cosine_topk as kcos
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cosine_topk import (cosine_topk_cuda,
                                             cosine_topk_interval_cuda,
                                             cosine_topk_masked_cuda)


@dataclasses.dataclass
class ExactState:
    """Empty index state: brute-force scoring reads the slab directly."""


@dataclasses.dataclass(frozen=True)
class ExactIndex:
    """Exact scoring. ``backend`` is ``'auto'`` (follow the device of the
    tensors), ``'torch'`` (the plain version on any device) or
    ``'kernel'`` (the CUDA kernel; raises on CPU tensors)."""

    topk: int = 4
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ops.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    def init(self, config: CacheConfig, device=None) -> ExactState:
        del config, device
        return ExactState()

    def search(self, istate: ExactState, queries: torch.Tensor,
               keys: torch.Tensor, alive: torch.Tensor, *,
               interval: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,d) x (N,d) -> (scores (B,k), slot ids (B,k) int32).

        ``alive`` is (N,), one mask for the whole batch, or (B, N) per row.
        ``interval`` = per-row ``(starts, sizes)`` operands restricting each
        row to a contiguous slot range on top of a shared (N,) ``alive``:
        the tenancy path, which stays on the interval kernel with O(B)
        operands. An interval on top of a (B, N) ``alive`` is folded into
        the mask, so the restriction is never dropped. Rows with no visible
        live slot return exactly (-inf, -1)."""
        del istate
        queries = l2_normalize(queries.to(torch.float32))
        if interval is not None and alive.dim() == 2:
            alive = interval_visibility(alive, *interval)
            interval = None
        if self.backend == "torch":
            if interval is not None:
                return ref.cosine_topk_interval_ref(queries, keys, alive,
                                                    *interval, self.topk)
            return ref.cosine_topk_ref(queries, keys, alive, self.topk)
        if self.backend == "kernel":
            if interval is not None:
                return cosine_topk_interval_cuda(queries, keys, alive,
                                                 *interval, self.topk)
            if alive.dim() == 2:
                return cosine_topk_masked_cuda(queries, keys, alive,
                                               self.topk)
            return cosine_topk_cuda(queries, keys, alive, self.topk)
        if interval is not None:
            return ops.cosine_topk_interval(queries, keys, alive, *interval,
                                            k=self.topk)
        return ops.cosine_topk(queries, keys, alive, k=self.topk)

    def absorb(self, istate: ExactState, slots: torch.Tensor,
               keys: torch.Tensor, mask: torch.Tensor) -> ExactState:
        del slots, keys, mask
        return istate

    def refit(self, istate: ExactState, keys: torch.Tensor,
              alive: torch.Tensor, rng: torch.Generator) -> ExactState:
        del keys, alive, rng
        return istate


@dataclasses.dataclass
class IVFState:
    centroids: torch.Tensor     # (C, d) f32, normalized
    buckets: torch.Tensor       # (C, cap) int32 slot ids, -1 padded
    bucket_valid: torch.Tensor  # (C, cap) bool


def dedup_candidates(cand: torch.Tensor, visible: torch.Tensor
                     ) -> torch.Tensor:
    """Suppress per-row duplicate candidate slot ids: ``visible`` with every
    later visible occurrence of an already-visible slot id turned off.

    A slot recycled across buckets (``absorb`` leaves stale pointers behind)
    can reach a row's candidates twice with identical scores and would take
    two of its k results. The first visible occurrence is kept, as
    ``top_k`` keeps the lowest position; invisible occurrences never
    suppress a visible one. cand: (B, M) int32; visible: (B, M) bool."""
    b, m = cand.shape
    pos = torch.arange(m, dtype=torch.int32, device=cand.device)[None, :]
    # invisible entries get unique sentinels above every real id (< 2**30)
    key = torch.where(visible, cand, 2 ** 30 + pos)
    order = torch.argsort(key, dim=1, stable=True)     # earliest first
    skey = torch.gather(key, 1, order)
    dup_sorted = torch.cat(
        [torch.zeros((b, 1), dtype=torch.bool, device=cand.device),
         skey[:, 1:] == skey[:, :-1]], dim=1)
    dup = torch.zeros_like(visible).scatter_(1, order, dup_sorted)
    return visible & ~dup


def _absorb_serial(buckets: torch.Tensor, bucket_valid: torch.Tensor,
                   assign: torch.Tensor, slots: torch.Tensor,
                   mask: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The serial absorb, oracle of the vectorized ``IVFIndex.absorb``: rows
    append in batch order at their bucket's fill point; once a bucket is
    full, later rows overwrite its tail slot (the last writer wins)."""
    buckets, bucket_valid = buckets.clone(), bucket_valid.clone()
    for i in range(slots.shape[0]):
        if not bool(mask[i]):
            continue
        c = int(assign[i])
        pos = min(int(bucket_valid[c].sum()), cap - 1)
        buckets[c, pos] = int(slots[i])
        bucket_valid[c, pos] = True
    return buckets, bucket_valid


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """Inverted-file ANN. ``refit`` = k-means rebuild; ``search`` = centroid
    probe + candidate top-k. ``backend`` (``'auto'|'torch'|'kernel'``) pins
    the candidate stage, as ``ExactIndex.backend`` pins its search; the
    probe follows the device of the tensors."""

    ncentroids: int = 64
    nprobe: int = 8
    bucket_cap: int = 512
    topk: int = 4
    kmeans_iters: int = 10
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ops.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    def init(self, config: CacheConfig, device=None) -> IVFState:
        """Empty index: random unit centroids (a CPU generator seeded 0, then
        moved to ``device``) and all-invalid buckets. Random rather than zero
        centroids spread pre-refit ``absorb``s over every bucket; ``refit``
        replaces them. ``device=None`` means CUDA, as at every entry point
        (``resolve_device``)."""
        device = resolve_device(device)
        c, cap = self.ncentroids, self.bucket_cap
        gen = torch.Generator().manual_seed(0)
        centroids = l2_normalize(torch.randn((c, config.dim), generator=gen))
        return IVFState(
            centroids=centroids.to(device),
            buckets=torch.full((c, cap), -1, dtype=torch.int32,
                               device=device),
            bucket_valid=torch.zeros((c, cap), dtype=torch.bool,
                                     device=device))

    def refit(self, istate: IVFState, keys: torch.Tensor, alive: torch.Tensor,
              rng: torch.Generator) -> IVFState:
        """K-means over the live keys from ``ncentroids`` rows drawn with
        ``rng`` (a CPU generator), weighted by ``alive + 1e-6`` as the JAX
        package draws them (dead rows only when few are alive)."""
        del istate  # a full rebuild from the slab
        p = alive.to("cpu", torch.float32) + 1e-6
        init_idx = torch.multinomial(p, self.ncentroids, replacement=True,
                                     generator=rng)
        return self.kmeans(keys, alive, init_idx.to(keys.device))

    def kmeans(self, keys: torch.Tensor, valid: torch.Tensor,
               init_idx: torch.Tensor) -> IVFState:
        """The deterministic part of ``refit``: ``kmeans_iters`` Lloyd steps
        from the rows ``init_idx``, argmax assignment, then each centroid's
        ``bucket_cap`` most similar members. Overflowing buckets drop their
        farthest members (the static-shape analogue of HNSW's bounded
        degree)."""
        if keys.dtype == torch.int8:
            keys = keys.to(torch.float32) / 127.0  # uniform slab dequant
        keys = keys.to(torch.float32)
        c = self.ncentroids
        vf = valid.to(torch.float32)
        centroids = l2_normalize(keys[init_idx.to(torch.int64)])
        for _ in range(self.kmeans_iters):
            assign = torch.argmax(keys @ centroids.T, dim=-1)
            onehot = torch.nn.functional.one_hot(assign, c).to(
                torch.float32) * vf[:, None]
            sums = onehot.T @ keys
            counts = onehot.sum(0)[:, None]
            new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                              centroids)
            centroids = l2_normalize(new)
        sims = keys @ centroids.T
        sims = torch.where(valid[:, None], sims,
                           torch.full_like(sims, NEG_INF))
        member_sim, assign = torch.max(sims, dim=-1)
        # each centroid's members by similarity, the top bucket_cap of them
        belong = torch.nn.functional.one_hot(assign, c).T.to(torch.bool) \
            & valid[None, :]
        member_scores = torch.where(belong, member_sim[None, :], NEG_INF)
        top_scores, top_idx = masked_topk(member_scores, self.bucket_cap)
        pad = self.bucket_cap - top_idx.shape[1]
        if pad:  # slab smaller than a bucket
            top_idx = torch.nn.functional.pad(top_idx, (0, pad), value=0)
            top_scores = torch.nn.functional.pad(top_scores, (0, pad),
                                                 value=NEG_INF)
        bucket_valid = top_scores > NEG_INF
        # row-major, as the IVF kernel reads the table (the top-k of the
        # transposed one-hot comes back column-major)
        buckets = torch.where(bucket_valid, top_idx,
                              torch.full_like(top_idx, -1)).to(
                                  torch.int32).contiguous()
        return IVFState(centroids=centroids, buckets=buckets,
                        bucket_valid=bucket_valid)

    def fit(self, keys: torch.Tensor, valid: torch.Tensor,
            rng: torch.Generator) -> IVFState:
        """From-scratch build."""
        return self.refit(None, keys, valid, rng)

    def absorb(self, istate: IVFState, slots: torch.Tensor,
               keys: torch.Tensor, mask: torch.Tensor) -> IVFState:
        """Index freshly inserted slab rows until the next refit: each masked
        row goes to its nearest centroid's bucket, overwriting the bucket's
        tail slot when it is full (the farthest members, restored at the
        next refit). Stale references to a recycled slot elsewhere in the
        table cost nothing: ``candidates`` scores the live key and
        suppresses per-row duplicates.

        Vectorized as in the JAX package: the batch is stable-sorted by
        centroid, a row's bucket position is the bucket's fill plus its rank
        in its centroid's run, positions clamp to the tail, and of the rows
        clamped onto one tail slot only the last in batch order writes,
        which equals the serial loop ``_absorb_serial``. Returns new tables;
        the ones passed in are not modified."""
        q = l2_normalize(keys.to(torch.float32))
        assign = torch.argmax(q @ istate.centroids.T, dim=-1).to(torch.int32)
        cap, c = self.bucket_cap, self.ncentroids
        dev = slots.device
        idx = torch.arange(slots.shape[0], dtype=torch.int32, device=dev)
        # masked-out rows sort to a sentinel group past every real centroid
        group = torch.where(mask, assign, torch.full_like(assign, c))
        order = torch.argsort(group, stable=True)
        sorted_g = group[order]
        change = sorted_g[1:] != sorted_g[:-1]
        true = torch.ones((1,), dtype=torch.bool, device=dev)
        is_start = torch.cat([true, change])
        first = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
        rank = idx - first                      # 0, 1, 2, ... per group
        fill0 = istate.bucket_valid.sum(1, dtype=torch.int32)
        pos = torch.clamp(
            fill0[torch.clamp(sorted_g, max=c - 1).to(torch.int64)] + rank,
            max=cap - 1)
        is_end = torch.cat([change, true])
        write = (sorted_g < c) & ((pos < cap - 1) | is_end)
        # rows that do not write go to a spare bucket row c, cut off after
        # the scatter (a boolean selection would wait for the device)
        tgt = (torch.where(write, sorted_g, c).to(torch.int64),
               pos.to(torch.int64))

        def scatter(table, values):
            spare = torch.cat([table, table[:1]])
            return spare.index_put_(tgt, values)[:c]
        buckets = scatter(istate.buckets, slots[order].to(torch.int32))
        bucket_valid = scatter(istate.bucket_valid, torch.ones_like(write))
        return IVFState(centroids=istate.centroids, buckets=buckets,
                        bucket_valid=bucket_valid)

    def candidates(self, istate: IVFState, q: torch.Tensor,
                   valid: torch.Tensor, *,
                   interval: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> torch.Tensor:
        """Probe + visibility: (B, d) normalized queries -> (B, M) int32
        candidate slot ids, M = nprobe * bucket_cap, -1 marking every
        invisible candidate (``probe_candidates`` without the probe)."""
        return self.probe_candidates(istate, q, valid, interval=interval)[0]

    def probe_candidates(self, istate: IVFState, q: torch.Tensor,
                         valid: torch.Tensor, *,
                         interval: tuple[torch.Tensor, torch.Tensor]
                         | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """(cand (B, M) int32, probe (B, P) int32): the probe is the cosine
        top-k over the centroids with an all-true mask (the CUDA kernel on
        the card), P = min(nprobe, ncentroids), and ``cand[b, j * cap + t]``
        is ``buckets[probe[b, j], t]`` or -1, the grouping the IVF kernel
        reads. Folded into the ids, in order: bucket-slot validity, slab
        aliveness (``valid``, (N,) shared or (B, N) per row), the per-row
        tenancy ``interval`` (compares on the gathered ids, never a (B, N)
        mask) and per-row duplicate suppression."""
        b = q.shape[0]
        p = min(self.nprobe, self.ncentroids)
        if q.device.type == "cuda" and p > kcos.MAX_K:
            raise ValueError(
                f"the centroid probe takes min(nprobe, ncentroids) = {p} "
                f"best centroids, above the cosine kernel's limit "
                f"MAX_K={kcos.MAX_K}")
        always = torch.ones((istate.centroids.shape[0],), dtype=torch.bool,
                            device=q.device)
        _, probe = ops.cosine_topk(q, istate.centroids, always, k=p)
        rows = probe.to(torch.int64)
        cand = istate.buckets[rows].reshape(b, -1)            # (B, M)
        visible = istate.bucket_valid[rows].reshape(b, -1)
        safe = torch.clamp(cand, min=0).to(torch.int64)
        if valid.dim() == 2:
            visible = visible & torch.gather(valid, 1, safe)
        else:
            visible = visible & valid[safe]
        if interval is not None:
            starts, sizes = interval
            visible = visible & (safe >= starts[:, None]) \
                & (safe < (starts + sizes)[:, None])
        visible = dedup_candidates(cand, visible)
        return torch.where(visible, cand, torch.full_like(cand, -1)), probe

    def search(self, istate: IVFState, queries: torch.Tensor,
               keys: torch.Tensor, valid: torch.Tensor, *,
               interval: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, d) -> (scores (B, k), slot ids (B, k) int32), probing
        ``nprobe`` buckets. ``valid`` is (N,) shared or (B, N) per row;
        ``interval`` restricts row b to ``[starts[b], starts[b] +
        sizes[b])``. Rows with no visible live candidate return
        (-inf, -1). The IVF kernel gets the probe and the bucket table, and
        scores each probed bucket's members once for all its rows."""
        q = l2_normalize(queries.to(torch.float32))
        cand, probe = self.probe_candidates(istate, q, valid,
                                            interval=interval)
        k = min(self.topk, cand.shape[1])
        return ops.ivf_topk(q, keys, cand, k=k, backend=self.backend,
                            probe=probe.to(torch.int32).contiguous(),
                            buckets=istate.buckets.contiguous())
