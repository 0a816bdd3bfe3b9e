"""SemanticCache — the paper's query-handling workflow (§2.5, §2.8), PyTorch
port of ``repro.core.cache``.

Workflow per batch of queries:
  1. embed (done by the caller / serving engine),
  2. ``lookup`` — search the slab, the threshold policy decides hit/miss,
  3. hit  -> cached response returned, LRU/LFU counters touched,
  4. miss -> caller generates with the LLM backend, then ``insert`` stores
     (embedding, response) and the index absorbs the new entries.

All mutable state lives in one ``CacheRuntime``; every method takes a
runtime and returns the next one. The slab tensors are updated in place
(see ``repro_torch.core.store``), so the runtime passed in must not be used
after a call that returns a new one. ``step`` keeps the padded fixed-shape
batch and its ``valid`` mask, so every batch has one shape.

    cache = SemanticCache(config)
    runtime = cache.init("cuda")
    peek, _ = cache.lookup(runtime, queries, now, update_counters=False)
    result, runtime = cache.step(runtime, queries, miss_values, miss_lens,
                                 now, peeked=peek, valid=valid)

Multi-tenancy: an optional ``partition`` (``repro_torch.tenancy.
PartitionMap``) splits the slab into disjoint per-tenant regions. A per-row
``tenant_id`` tensor restricts every lookup to its row's own region (per-row
interval operands, the interval kernel on CUDA) and routes every insert
into its row's own ring, so cross-tenant hits are impossible by
construction and one batch may mix tenants freely.

Multi-turn context: an optional ``fusion`` plugin (``repro_torch.context.
ContextFusion``) pools each row's session turn window — a ``(B, W, d)``
tensor and a ``(B,)`` length vector — into the lookup key before the
search and before the insert, so the slab keys are dialogue-state
embeddings. Rows with an empty window pass through bit-identically.
Fusion weights live in the runtime's ``fusion`` leaf group.

Near-hit band: a policy with a ``near`` method (``repro_torch.generative.
BandPolicy``) marks the rows scoring in [τ_lo, τ_hi) in
``LookupResult.near``; a tenant's ``band_lo`` override replaces τ_lo for
its rows, and ``update_band`` feeds judged near-hit outcomes back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import store
from repro_torch.core.index import ExactIndex
from repro_torch.core.policy import FixedThreshold
from repro_torch.core.runtime import CacheRuntime
from repro_torch.core.types import (CacheConfig, CacheStats, LookupResult,
                                    init_cache_state, resolve_device)
from repro_torch.tenancy.partition import TenancyState


class _LocalComm:
    """Identity communication seam: the single-device form of the points in
    ``lookup``/``commit``/``insert`` where a sharded step would cross
    shards (top-k merge, best-row fetch, touch ownership, counter
    attribution, insert routing). The sharded slice substitutes its own."""

    #: shards participating in the step
    num_shards: int = 1

    def merge_topk(self, top_s: torch.Tensor, top_i: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        return top_s, top_i

    def fetch_best(self, state, top0: torch.Tensor):
        """(values, value_lens, source_id) rows of each row's best slot
        (-1 = no visible slot; that row's payload is unused)."""
        idx = torch.clamp(top0, min=0).to(torch.int64)
        return state.values[idx], state.value_lens[idx], state.source_id[idx]

    def touch(self, state, slot: torch.Tensor, now, hit: torch.Tensor):
        return store.touch(state, slot, now, hit)

    def primary(self, counts: torch.Tensor) -> torch.Tensor:
        return counts

    def insert_take(self, mask: torch.Tensor, n_inserts: torch.Tensor
                    ) -> torch.Tensor:
        return mask

    def prepare_insert(self, state):
        return state

    def finalize_insert(self, state, prev_n_inserts: torch.Tensor,
                        mask: torch.Tensor):
        return state


LOCAL_COMM = _LocalComm()


def topk_payload(result: LookupResult, rows) -> dict[str, torch.Tensor]:
    """``gather_topk``'s payload, ``rows(name, idx)`` fetching slab rows."""
    idx = torch.clamp(result.topk_index, min=0)
    ok = result.topk_index >= 0
    return {
        "values": torch.where(ok[..., None], rows("values", idx), 0),
        "value_lens": torch.where(ok, rows("value_lens", idx), 0),
        "source_id": torch.where(ok, rows("source_id", idx), -1),
        "score": torch.where(ok, result.topk_score,
                             torch.full_like(result.topk_score,
                                             float("-inf"))),
    }


@dataclasses.dataclass(frozen=True)
class SemanticCache:
    """Stateless orchestrator; all state lives in one CacheRuntime."""

    config: CacheConfig
    index: Any = None          # Index protocol plugin (None -> ExactIndex)
    policy: Any = None         # Policy protocol plugin (None -> FixedThreshold)
    partition: Any = None      # PartitionMap for multi-tenant regions
    fusion: Any = None         # ContextFusion plugin for session windows

    def __post_init__(self):
        if self.partition is not None:
            if self.partition.capacity != self.config.capacity:
                raise ValueError(
                    f"partition covers {self.partition.capacity} slots, "
                    f"slab capacity is {self.config.capacity}")
            if self.config.eviction != "ring":
                # per-tenant LRU/LFU would need an in-region arg-min scan;
                # refusing beats evicting across regions
                raise ValueError(
                    "tenant partitioning currently supports ring eviction "
                    f"only (got {self.config.eviction!r})")
        if self.index is None:
            object.__setattr__(self, "index", ExactIndex(topk=self.config.topk))
        if self.policy is None:
            object.__setattr__(
                self, "policy", FixedThreshold(threshold=self.config.threshold))

    # -- state ------------------------------------------------------------
    def init(self, device: str | torch.device = "cuda") -> CacheRuntime:
        """Fresh runtime on ``device``: empty slab, zero counters, initial
        policy and index state (and per-tenant ring pointers and counters
        when partitioned, fusion weights when context-fused)."""
        dev = resolve_device(device)
        return CacheRuntime(
            state=init_cache_state(self.config, dev),
            stats=CacheStats.zeros(dev),
            policy_state=self.policy.init_state(dev),
            index_state=self.index.init(self.config, dev),
            tenancy=None if self.partition is None
            else TenancyState.zeros(len(self.partition), dev),
            fusion=None if self.fusion is None
            else self.fusion.init_state(dev),
        )

    # -- context fusion (no-op when fusion is None) ------------------------
    def _maybe_fuse(self, runtime: CacheRuntime, queries: torch.Tensor,
                    window: torch.Tensor | None,
                    window_len: torch.Tensor | None) -> torch.Tensor:
        """Pool each row's turn window into its lookup key.
        ``window=None`` (or a fusion-less cache) is the stateless path:
        queries unchanged."""
        if self.fusion is None or window is None:
            return queries
        if window_len is None:
            raise ValueError("window without window_len")
        return self.fusion.fuse(
            runtime.fusion, queries, window,
            torch.as_tensor(window_len, dtype=torch.int32,
                            device=queries.device))

    # -- tenancy helpers (no-ops when partition is None) -------------------
    def _require_tenants(self, tenant_id, device: torch.device
                         ) -> torch.Tensor | None:
        """A partitioned cache must be told each row's tenant; an
        unpartitioned one ignores the argument."""
        if self.partition is None:
            return None
        if tenant_id is None:
            raise ValueError("cache is tenant-partitioned: every call needs "
                             "a per-row tenant_id vector")
        return torch.as_tensor(tenant_id, dtype=torch.int32, device=device)

    def _tenant_interval(self, tenant_id: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """(B,) tenant ids -> per-row ``(starts, sizes)`` operands: a row
        sees only its own region's slots, so a cosine-1.0 duplicate in
        another tenant's region is invisible, not just sub-threshold."""
        dev, tid = tenant_id.device, tenant_id.to(torch.int64)
        return (self.partition.starts_array(dev)[tid],
                self.partition.sizes_array(dev)[tid])

    def _apply_threshold_overrides(self, hit: torch.Tensor,
                                   score: torch.Tensor,
                                   tenant_id: torch.Tensor) -> torch.Tensor:
        """Rows of a tenant with a threshold override re-decide against it;
        the others keep the policy's decision (negative = no override)."""
        thr = self.partition.thresholds_array(tenant_id.device)[
            tenant_id.to(torch.int64)]
        return torch.where(thr >= 0.0, score >= thr, hit)

    def _account_lookups(self, tenancy, tenant_id: torch.Tensor | None, *,
                         hit: torch.Tensor, valid: torch.Tensor | None,
                         comm: _LocalComm = LOCAL_COMM):
        """Scatter-add one batch of lookups and hits into the per-tenant
        counters; padding rows (``valid=False``) add nothing."""
        if tenancy is None or tenant_id is None:
            return tenancy
        ones = torch.ones_like(tenant_id)
        if valid is not None:
            ones = torch.where(valid, ones, 0)
        ones = comm.primary(ones)
        tid = tenant_id.to(torch.int64)
        return dataclasses.replace(
            tenancy,
            lookups=tenancy.lookups.index_add(0, tid, ones),
            hits=tenancy.hits.index_add(0, tid, torch.where(hit, ones, 0)))

    # -- near-hit band (all-False unless the policy defines one) -----------
    def _near_mask(self, hit: torch.Tensor, score: torch.Tensor,
                   tenant_id: torch.Tensor | None, pstate: torch.Tensor
                   ) -> torch.Tensor:
        """[τ_lo, τ_hi) band membership per row, or all-False on a band-less
        policy. ``& ~hit`` makes the upper edge the effective hit edge,
        per-tenant τ_hi overrides included, and a per-tenant ``band_lo``
        override (negative = none) replaces the lower edge."""
        if not hasattr(self.policy, "near"):
            return torch.zeros_like(hit)
        near = self.policy.near(score, pstate)
        if tenant_id is not None:
            lo = self.partition.band_lo_array(tenant_id.device)[
                tenant_id.to(torch.int64)]
            near = torch.where(lo >= 0.0, score >= lo, near)
        return near & ~hit & (score > float("-inf"))

    # -- lookup (paper §2.5 step 1) ----------------------------------------
    def lookup(self, runtime: CacheRuntime, queries: torch.Tensor, now, *,
               update_counters: bool = True,
               tenant_id: torch.Tensor | None = None,
               window: torch.Tensor | None = None,
               window_len: torch.Tensor | None = None,
               comm: _LocalComm = LOCAL_COMM
               ) -> tuple[LookupResult, CacheRuntime]:
        """Search + threshold decision. ``update_counters=False`` is a pure
        peek (no LRU touch, no stats, no policy-state commit): the engine
        uses it to learn the miss set before the fused ``step``. On a
        partitioned cache ``tenant_id`` (B,) is required and each row
        searches only its tenant's region. On a context-fused cache
        ``window`` (B, W, d) and ``window_len`` (B,) carry each row's
        session turns and the search key is the fused embedding; rows with
        ``window_len == 0`` search on the raw query."""
        queries = self._maybe_fuse(runtime, queries, window, window_len)
        state, stats = runtime.state, runtime.stats
        tenant_id = self._require_tenants(tenant_id, state.keys.device)
        b = queries.shape[0]
        alive = store.alive_mask(state, now)
        interval = None
        if tenant_id is not None:
            interval = self._tenant_interval(tenant_id)
        top_s, top_i = self.index.search(runtime.index_state, queries,
                                         state.keys, alive,
                                         interval=interval)
        top_s, top_i = comm.merge_topk(top_s, top_i)

        best_idx = torch.clamp(top_i[:, 0], min=0)   # -1 guard: empty cache
        best_score = torch.where(top_i[:, 0] >= 0, top_s[:, 0],
                                 torch.full_like(top_s[:, 0], float("-inf")))
        hit, pstate = self.policy.decide(best_score, runtime.policy_state)
        if tenant_id is not None:
            hit = self._apply_threshold_overrides(hit, best_score, tenant_id)
        hit = hit & (best_score > float("-inf"))
        near = self._near_mask(hit, best_score, tenant_id,
                               runtime.policy_state)

        values, value_lens, src = comm.fetch_best(state, top_i[:, 0])
        result = LookupResult(
            index=best_idx.to(torch.int32), score=best_score, hit=hit,
            values=values, value_lens=value_lens, source_id=src,
            topk_index=top_i, topk_score=top_s, near=near)
        if not update_counters:
            return result, runtime
        state = comm.touch(state, best_idx, now, hit)
        stats = stats.record_lookups(b, hit.sum(dtype=torch.int32))
        tenancy = self._account_lookups(runtime.tenancy, tenant_id, hit=hit,
                                        valid=None, comm=comm)
        return result, runtime.replace(state=state, stats=stats,
                                       policy_state=pstate, tenancy=tenancy)

    def gather_topk(self, runtime: CacheRuntime, result: LookupResult
                    ) -> dict[str, torch.Tensor]:
        """Top-k neighbour payload of a lookup result: cached responses,
        lengths, provenance and scores of every visible neighbour. Invalid
        neighbours (index -1) come back with length 0, source -1 and score
        -inf. A pure gather that touches no counter."""
        return topk_payload(result, lambda name, idx: self.slab_rows(
            runtime, name, idx))

    def slab_rows(self, runtime: CacheRuntime, name: str,
                  idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (slot ids >= 0, any shape) of the slab leaf
        ``name``."""
        return getattr(runtime.state, name)[idx.to(torch.int64)]

    # -- insert (paper §2.5 step 3) -----------------------------------------
    def insert(self, runtime: CacheRuntime, queries: torch.Tensor,
               values: torch.Tensor, value_lens: torch.Tensor, now, *,
               source_id: torch.Tensor | None = None,
               mask: torch.Tensor | None = None,
               tenant_id: torch.Tensor | None = None,
               comm: _LocalComm = LOCAL_COMM) -> CacheRuntime:
        """Insert the rows where ``mask`` is set; on a partitioned cache
        each row goes into its tenant's own ring (``tenant_id`` required),
        so a tenant can only ever overwrite itself."""
        tenant_id = self._require_tenants(tenant_id, queries.device)
        if mask is None:
            mask = torch.ones((queries.shape[0],), dtype=torch.bool,
                              device=queries.device)
        take = comm.insert_take(mask, runtime.state.n_inserts)
        state0 = comm.prepare_insert(runtime.state)
        prev_n_inserts = runtime.state.n_inserts
        tenancy = runtime.tenancy
        slots = None
        if tenant_id is not None:
            slots, new_ptr = store.select_slots_tenant(
                self.partition, tenancy.ptr, tenant_id, take)
            # read before the insert overwrites the slab in place
            alive_before = store.alive_mask(state0, now)
            ones = torch.ones_like(tenant_id)
            tid = tenant_id.to(torch.int64)
            evicted = torch.where(
                take & alive_before[slots.to(torch.int64)], ones, 0)
            tenancy = dataclasses.replace(
                tenancy, ptr=new_ptr,
                inserts=tenancy.inserts.index_add(
                    0, tid, torch.where(take, ones, 0)),
                evictions=tenancy.evictions.index_add(0, tid, evicted))
        state, slots = store.insert(
            self.config, state0, queries, values, value_lens, now,
            source_id=source_id, mask=take, slots=slots)
        state = comm.finalize_insert(state, prev_n_inserts, mask)
        istate = self.index.absorb(runtime.index_state, slots, queries, take)
        stats = dataclasses.replace(
            runtime.stats,
            inserts=runtime.stats.inserts + mask.sum(dtype=torch.int32))
        return runtime.replace(state=state, stats=stats, index_state=istate,
                               tenancy=tenancy)

    # -- maintenance (paper §2.7 TTL; §2.4 rebalancing) ----------------------
    def expire(self, runtime: CacheRuntime, now) -> CacheRuntime:
        state, n = store.expire(runtime.state, now)
        stats = dataclasses.replace(
            runtime.stats,
            expired_evictions=runtime.stats.expired_evictions + n)
        return runtime.replace(state=state, stats=stats)

    def refit(self, runtime: CacheRuntime, now, rng) -> CacheRuntime:
        """Periodic index rebuild (§2.4) drawing from the ``repro_torch.prng``
        key ``rng``; a no-op for stateless indexes."""
        alive = store.alive_mask(runtime.state, now)
        istate = self.index.refit(runtime.index_state, runtime.state.keys,
                                  alive, rng)
        return runtime.replace(index_state=istate)

    def update_policy(self, runtime: CacheRuntime, *,
                      was_positive: torch.Tensor, was_hit: torch.Tensor
                      ) -> CacheRuntime:
        """Judged-outcome feedback into the policy (paper §2.10 loop)."""
        pstate = self.policy.update(runtime.policy_state,
                                    was_positive=was_positive, was_hit=was_hit)
        return runtime.replace(policy_state=pstate)

    def update_band(self, runtime: CacheRuntime, *,
                    was_positive: torch.Tensor, was_near: torch.Tensor
                    ) -> CacheRuntime:
        """Judged synthesized-answer outcomes into the band edge, the
        near-hit analogue of ``update_policy``; a no-op on a band-less
        policy."""
        if not hasattr(self.policy, "update_band"):
            return runtime
        pstate = self.policy.update_band(
            runtime.policy_state, was_positive=was_positive,
            was_near=was_near)
        return runtime.replace(policy_state=pstate)

    # -- fused serve-side step (DESIGN.md §7) -------------------------------
    def commit(self, runtime: CacheRuntime, peeked: LookupResult, now, *,
               valid: torch.Tensor | None = None,
               tenant_id: torch.Tensor | None = None,
               comm: _LocalComm = LOCAL_COMM
               ) -> tuple[LookupResult, CacheRuntime]:
        """Commit a peeked lookup (counters, LRU touch, policy state)
        without searching again. The hit mask is re-derived from the peeked
        scores against the current policy state, so peek -> commit equals a
        counted ``lookup``. ``valid`` marks the real rows of a padded batch:
        padding rows stay out of the hit mask, the touch and every
        counter, the per-tenant ones included."""
        tenant_id = self._require_tenants(tenant_id, peeked.score.device)
        hit, pstate = self.policy.decide(peeked.score, runtime.policy_state)
        if tenant_id is not None:
            hit = self._apply_threshold_overrides(hit, peeked.score,
                                                  tenant_id)
        hit = hit & (peeked.score > float("-inf"))
        near = self._near_mask(hit, peeked.score, tenant_id,
                               runtime.policy_state)
        if valid is None:
            n_lookups = peeked.score.shape[0]
        else:
            hit = hit & valid
            near = near & valid
            n_lookups = valid.sum(dtype=torch.int32)
        result = dataclasses.replace(peeked, hit=hit, near=near)
        state = comm.touch(runtime.state, peeked.index, now, hit)
        stats = runtime.stats.record_lookups(n_lookups,
                                             hit.sum(dtype=torch.int32))
        tenancy = self._account_lookups(runtime.tenancy, tenant_id, hit=hit,
                                        valid=valid, comm=comm)
        return result, runtime.replace(state=state, stats=stats,
                                       policy_state=pstate, tenancy=tenancy)

    def step(self, runtime: CacheRuntime, queries: torch.Tensor,
             miss_values: torch.Tensor, miss_value_lens: torch.Tensor, now, *,
             source_id: torch.Tensor | None = None,
             peeked: LookupResult | None = None,
             valid: torch.Tensor | None = None,
             tenant_id: torch.Tensor | None = None,
             window: torch.Tensor | None = None,
             window_len: torch.Tensor | None = None,
             comm: _LocalComm = LOCAL_COMM
             ) -> tuple[LookupResult, CacheRuntime]:
        """Lookup, then insert exactly the missed queries' fresh responses.

        ``miss_values`` carries a response row for every query (rows of hits
        are ignored through the insert mask), so the step has one shape per
        batch. ``peeked`` (from ``lookup(update_counters=False)``) skips the
        search: the slab is searched once per batch. ``valid`` marks the
        real rows of a padded batch: padding rows neither count nor get
        inserted. ``tenant_id`` (required when partitioned) may mix tenants
        in any proportion. ``window``/``window_len`` (context-fused cache)
        pool each row's session turns into its key once here: the same
        fused key searches the slab and, on a miss, is the inserted key."""
        queries = self._maybe_fuse(runtime, queries, window, window_len)
        if peeked is None and valid is None:
            result, runtime = self.lookup(runtime, queries, now,
                                          tenant_id=tenant_id, comm=comm)
        else:
            if peeked is None:
                peeked, _ = self.lookup(runtime, queries, now,
                                        update_counters=False,
                                        tenant_id=tenant_id, comm=comm)
            result, runtime = self.commit(runtime, peeked, now, valid=valid,
                                          tenant_id=tenant_id, comm=comm)
        insert_mask = ~result.hit
        if valid is not None:
            insert_mask = insert_mask & valid
        runtime = self.insert(runtime, queries, miss_values, miss_value_lens,
                              now, source_id=source_id, mask=insert_mask,
                              tenant_id=tenant_id, comm=comm)
        return result, runtime
