"""DistributedCache — the sharded semantic cache (paper §2.10 "Distributed
Caching", DESIGN.md §19), PyTorch port of ``repro.core.distributed``.

The paper scales its Redis store by clustering. The reference splits the
slab's capacity axis over a device mesh and runs the *same*
``SemanticCache`` step body on every shard under ``shard_map``, with the
cross-shard dataflow routed through the cache's communication seam
(``_LocalComm``). This port keeps that design with one controller: the
shard bodies are the port's own ``SemanticCache.lookup``, ``step``,
``insert`` and ``refit``, unchanged, each run with its shard's
``_MeshComm`` on one of S host threads at once, which is what
``shard_map`` does. The seams:

  merge_topk   — per-shard top-k candidates become (score, global_slot)
                 pairs, gathered from every shard in shard order and
                 re-ranked per row by a stable sort, so tied scores break
                 to the lowest global slot, as ``top_k`` breaks them to
                 the first position;
  fetch_best   — each shard contributes its owned rows' payload (values,
                 lengths, provenance), summed over the shards;
  touch        — only the owning shard touches LRU/LFU counters;
  primary      — per-batch lookup/hit counts are attributed on shard 0
                 only, so the sum over the (S, T) tenancy counters is
                 exact;
  insert_take  — round-robin routing by the rank of each *masked-in* row,
                 offset by the replicated global insert clock;
  prepare/finalize_insert — a shard's ring pointer comes from the
                 replicated clock (shard ``s`` holds ``ceil((n - s) / S)``
                 of the first ``n`` round-robin inserts), and after the
                 write the clock is re-replicated: ``n_inserts`` advances
                 by the global masked count, ``ptr`` parks at 0.

A collective is a barrier of the S threads plus an exchange in shard
order, so its result does not depend on which thread arrives first, and
between collectives the bodies take turns in shard order (``_Group``), so
one of them holds the interpreter at a time. A body that raises aborts
the group: every other thread leaves its wait, and the caller gets the
first exception. The threads live in one pool per ``DistributedCache``;
one call runs at a time. On one device all threads launch onto the
caller's stream, in the order the turns give.

Slot ids are shard-major: global slot ``g`` lives on shard
``g // local_capacity`` at local row ``g % local_capacity``, which is the
row of the global slab tensors, so every global-view consumer
(``gather_topk``, checkpoints, explain) indexes the global slab directly.

State layout, as the reference's (DESIGN.md §19.3):
  * ``CacheState`` (N, ...) leaves are global tensors in shard-major
    order; a shard body gets views of its rows, and the store's in-place
    updates write through them. ``ptr`` / ``n_inserts`` are replicated;
  * index state is stacked on the leading axis, e.g. IVF centroids
    (S·C, d) and buckets (S·C, cap) of *local* slot ids;
  * ``TenancyState`` leaves are (S, T);
  * ``CacheStats``, policy state and fusion weights are replicated.
Every shard body gets its own copy of the replicated leaves (shards after
the first a clone) and its own state containers, since each shard's
``ptr`` differs; after the call shard 0's replicated leaves are kept.

In this port every shard sits on the mesh's one device. A mesh over
distinct devices is ROADMAP item A6b.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import threading
import weakref
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import store
from repro_torch.core.cache import SemanticCache, _LocalComm
from repro_torch.core.runtime import CacheRuntime
from repro_torch.core.types import CacheState, LookupResult, resolve_device
from repro_torch.tenancy.partition import TenancyState

_CLOCK = ("ptr", "n_inserts")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The port's counterpart of ``jax.sharding.Mesh``: named axes of
    shards. ``shape`` maps each axis name to its size, as ``Mesh.shape``
    does; every shard sits on ``device``."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> ShardMesh:
    """A mesh of ``prod(shape)`` shards with the named axes, the
    counterpart of ``jax.make_mesh``. ``device=None`` means CUDA, as at
    every entry point; a sequence of devices must name one device."""
    shape, names = tuple(int(x) for x in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} must "
                         "pair up, one distinct name per axis")
    if any(x < 1 for x in shape):
        raise ValueError(f"mesh axis sizes must be positive: {shape}")
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if not devs or any(not _same_device(d, devs[0]) for d in devs):
            raise ValueError(
                f"a mesh over distinct devices {[str(d) for d in devs]} is "
                "not supported yet (ROADMAP A6b): every shard runs on one "
                "device")
        device = devs[0]
    return ShardMesh(names, shape, resolve_device(device))


def shard_axes(mesh: ShardMesh, cache_axes: tuple[str, ...]) -> int:
    """Number of slab shards: the product of the mesh axes the capacity
    axis is split over."""
    return math.prod(int(mesh.shape[a]) for a in cache_axes)


class _Aborted(Exception):
    """Another shard's body raised: this one leaves its wait."""


class _Group:
    """The rendezvous of one SPMD call's S shard bodies. The bodies take
    turns in shard order: a shard runs until its next collective, or its
    end, and hands the turn to the next shard; the last shard to reach a
    collective completes it and hands the turn back to shard 0. So a
    collective is a barrier with an exchange in shard order, and one body
    runs at a time. The bodies' host work is serial under the interpreter
    lock anyway; taking turns spares every tensor operation, which lets
    go of that lock, a hand-off of it between runnable threads.

    Exchanges use two buffers in turns: round r + 2 overwrites round r's
    only after every shard has passed round r + 1, so after every shard
    has read round r's values."""

    def __init__(self, n: int):
        self.n = n
        self.go = [threading.Event() for _ in range(n)]
        self.go[0].set()
        self.aborted = False
        self.buffers = ([None] * n, [None] * n)

    def wait_turn(self, shard: int) -> None:
        self.go[shard].wait()
        self.go[shard].clear()
        if self.aborted:
            raise _Aborted

    def pass_turn(self, shard: int) -> None:
        self.go[(shard + 1) % self.n].set()

    def abort(self) -> None:
        self.aborted = True
        for ev in self.go:
            ev.set()


class _MeshComm(_LocalComm):
    """One shard's side of the cache's cross-shard seam: the same
    ``SemanticCache`` method bodies run on every shard; these overrides put
    the exchanges at the combine points."""

    def __init__(self, shard: int, num_shards: int, local_capacity: int,
                 group: _Group):
        self.shard = shard
        self.num_shards = num_shards
        self.local_capacity = local_capacity
        self.group = group
        self._round = 0

    def all_gather(self, value) -> list:
        """Every shard's ``value``, in shard order (a barrier)."""
        g = self.group
        buf = g.buffers[self._round % 2]
        self._round += 1
        buf[self.shard] = value
        g.pass_turn(self.shard)
        g.wait_turn(self.shard)
        return list(buf)

    # -- lookup seams ------------------------------------------------------
    def merge_topk(self, top_s: torch.Tensor, top_i: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        k = top_i.shape[1]
        gid = torch.where(top_i >= 0,
                          top_i + self.shard * self.local_capacity, -1)
        parts = self.all_gather((top_s, gid))
        s_all = torch.cat([p[0] for p in parts], dim=1)      # (B, S*k)
        i_all = torch.cat([p[1] for p in parts], dim=1)
        # stable: of tied scores the first position, the lowest global
        # slot, comes first (torch.topk promises no order among ties)
        merged_s, sel = torch.sort(s_all, dim=1, descending=True,
                                   stable=True)
        merged_s, sel = merged_s[:, :k], sel[:, :k]
        merged_i = torch.gather(i_all, 1, sel)
        merged_i = torch.where(merged_s > float("-inf"), merged_i, -1)
        return merged_s, merged_i.to(torch.int32)

    def fetch_best(self, state, top0: torch.Tensor):
        lc = self.local_capacity
        mine = (top0 >= 0) & (top0 // lc == self.shard)
        lidx = torch.where(mine, top0 % lc, 0).to(torch.int64)
        payload = torch.cat(
            [state.values[lidx].to(torch.int32),
             state.value_lens[lidx].to(torch.int32)[:, None],
             state.source_id[lidx].to(torch.int32)[:, None]], dim=1)
        payload = torch.where(mine[:, None], payload, 0)
        total = torch.stack(self.all_gather(payload)).sum(
            0, dtype=torch.int32)
        return total[:, :-2], total[:, -2], total[:, -1]

    def touch(self, state, slot: torch.Tensor, now, hit: torch.Tensor):
        lc = self.local_capacity
        mine = slot // lc == self.shard
        return store.touch(state, torch.where(mine, slot % lc, 0), now,
                           hit & mine)

    def primary(self, counts: torch.Tensor) -> torch.Tensor:
        return counts if self.shard == 0 else torch.zeros_like(counts)

    # -- insert seams ------------------------------------------------------
    def insert_take(self, mask: torch.Tensor, n_inserts: torch.Tensor
                    ) -> torch.Tensor:
        mi = mask.to(torch.int32)
        rank = torch.cumsum(mi, 0, dtype=torch.int32) - mi  # among masked-in
        owner = (n_inserts + rank) % self.num_shards
        return mask & (owner == self.shard)

    def prepare_insert(self, state):
        # after n global round-robin inserts shard s holds ceil((n - s) / S)
        s = self.num_shards
        fill = (state.n_inserts + (s - 1 - self.shard)) // s
        return dataclasses.replace(
            state, ptr=(fill % self.local_capacity).to(torch.int32))

    def finalize_insert(self, state, prev_n_inserts: torch.Tensor,
                        mask: torch.Tensor):
        return dataclasses.replace(
            state, ptr=torch.zeros_like(state.ptr),   # re-derived next insert
            n_inserts=prev_n_inserts + mask.sum(dtype=torch.int32))


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@dataclasses.dataclass(frozen=True)
class DistributedCache:
    """Capacity-sharded ``SemanticCache`` with the same method surface.

    ``cache`` is the *global* description (full capacity, global
    partition); each shard runs a derived shard-local cache (capacity and
    regions divided by the shard count, the same index, policy and fusion
    plugins) with its ``_MeshComm``. Methods that never cross shards —
    ``expire``, ``gather_topk``, ``update_policy``, ``update_band``,
    ``_maybe_fuse`` — delegate to the global view (global slot ids are
    global rows).

    ``config`` / ``partition`` / ``policy`` / ``index`` / ``fusion`` mirror
    the inner cache, and ``lookup`` / ``step`` / ``insert`` / ``refit``
    take the same arguments, so ``CachedEngine`` and the async scheduler
    drive a mesh without a special case (DESIGN.md §19.4). The runtime
    passed to a call must not be used after it, as with ``SemanticCache``.
    """

    cache: SemanticCache
    mesh: ShardMesh
    cache_axes: tuple[str, ...] = ("data",)

    def __post_init__(self):
        object.__setattr__(self, "cache_axes", tuple(self.cache_axes))
        for a in self.cache_axes:
            if a not in self.mesh.shape:
                raise ValueError(f"mesh has no axis {a!r}: {self.mesh.shape}")
        s = self.num_shards
        cfg = self.cache.config
        if cfg.capacity % s != 0:
            raise ValueError(f"capacity {cfg.capacity} not divisible by "
                             f"{s} shards")
        part = self.cache.partition
        local_part = None
        if part is not None:
            if any(sz % s for sz in part.sizes):
                raise ValueError(
                    f"per-tenant region sizes {part.sizes} must be "
                    f"multiples of the shard count {s} (size regions in "
                    f"shard-count multiples)")
            local_part = dataclasses.replace(
                part, starts=tuple(x // s for x in part.starts),
                sizes=tuple(x // s for x in part.sizes),
                capacity=cfg.capacity // s)
        local = SemanticCache(
            config=dataclasses.replace(cfg, capacity=cfg.capacity // s),
            index=self.cache.index, policy=self.cache.policy,
            partition=local_part, fusion=self.cache.fusion)
        object.__setattr__(self, "local", local)
        object.__setattr__(self, "_lock", threading.Lock())
        pool = None
        if s > 1:
            # shard 0 runs on the calling thread, the others here
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=s - 1, thread_name_prefix="cache-shard")
            weakref.finalize(self, pool.shutdown, False)
        object.__setattr__(self, "_pool", pool)

    # -- engine-facing mirrors --------------------------------------------
    @property
    def config(self):
        return self.cache.config

    @property
    def partition(self):
        return self.cache.partition

    @property
    def policy(self):
        return self.cache.policy

    @property
    def index(self):
        return self.cache.index

    @property
    def fusion(self):
        return self.cache.fusion

    @property
    def num_shards(self) -> int:
        return shard_axes(self.mesh, self.cache_axes)

    @property
    def local_capacity(self) -> int:
        return self.cache.config.capacity // self.num_shards

    def shard_layout(self) -> dict:
        """JSON-able record of the sharded placement, written into
        checkpoint manifests and compared (or resharded against) on load;
        the keys are the JAX package's."""
        return {
            "num_shards": self.num_shards,
            "cache_axes": list(self.cache_axes),
            "mesh_axes": [str(a) for a in self.mesh.axis_names],
            "mesh_shape": [int(self.mesh.shape[a])
                           for a in self.mesh.axis_names],
            "local_capacity": self.local_capacity,
        }

    # -- state ------------------------------------------------------------
    def _device(self, device) -> torch.device:
        if device is None:
            return self.mesh.device
        dev = resolve_device(device)
        if not _same_device(dev, self.mesh.device):
            raise ValueError(f"device {dev} is not the mesh's device "
                             f"{self.mesh.device}")
        return dev

    def init(self, device=None) -> CacheRuntime:
        """Fresh sharded runtime on the mesh's device. Slab, stats, policy
        and fusion leaves come from the global init; index state tiles the
        *local* init S times on the leading axis (the index init is
        deterministic, so S tiles equal S shard inits) and tenancy state
        stacks it into (S, T) leaves."""
        dev = self._device(device)
        g, loc = self.cache.init(dev), self.local.init(dev)
        s = self.num_shards
        index_state = type(loc.index_state)(**{
            n: torch.cat([x] * s)
            for n, x in _fields(loc.index_state).items()})
        tenancy = None
        if loc.tenancy is not None:
            tenancy = TenancyState(**{
                n: torch.stack([x] * s)
                for n, x in _fields(loc.tenancy).items()})
        return CacheRuntime(state=g.state, stats=g.stats,
                            policy_state=g.policy_state,
                            index_state=index_state, tenancy=tenancy,
                            fusion=g.fusion)

    def place(self, runtime: CacheRuntime) -> CacheRuntime:
        """Every leaf on the mesh's device, contiguous, with the sharded
        layout's leading dims checked: (N, ...) slab, (S·C, ...) index and
        (S, T) tenancy leaves."""
        dev, s, n = self.mesh.device, self.num_shards, self.config.capacity

        def to(group, lead=None, what=""):
            if group is None:
                return None
            if isinstance(group, torch.Tensor):
                return group.to(dev).contiguous()
            out = {}
            for name, x in _fields(group).items():
                if lead is not None and x.dim() and lead(x.shape[0]):
                    raise ValueError(f"{what} leaf {name!r} has leading dim "
                                     f"{x.shape[0]}, not the layout of "
                                     f"{s} shard(s)")
                out[name] = x.to(dev).contiguous()
            return type(group)(**out)
        return CacheRuntime(
            state=to(runtime.state, lambda m: m != n, "slab"),
            stats=to(runtime.stats), policy_state=to(runtime.policy_state),
            index_state=to(runtime.index_state, lambda m: m % s, "index"),
            tenancy=to(runtime.tenancy, lambda m: m != s, "tenancy"),
            fusion=to(runtime.fusion))

    # -- global <-> shard-local views -------------------------------------
    def _to_local(self, rt: CacheRuntime, i: int) -> CacheRuntime:
        """Shard ``i``'s runtime: views of its slab rows, index rows and
        tenancy row; its own copy of the replicated leaves."""
        lc, s = self.local_capacity, self.num_shards

        def own(x):
            return x if i == 0 else x.clone()

        def rows(x):
            m = x.shape[0] // s
            return x[i * m:(i + 1) * m]
        st = _fields(rt.state)
        state = CacheState(**{n: (own(x) if n in _CLOCK
                                  else x[i * lc:(i + 1) * lc])
                              for n, x in st.items()})
        return CacheRuntime(
            state=state,
            stats=type(rt.stats)(**{n: own(x) for n, x in
                                    _fields(rt.stats).items()}),
            policy_state=own(rt.policy_state),
            index_state=type(rt.index_state)(**{
                n: rows(x) for n, x in _fields(rt.index_state).items()}),
            tenancy=None if rt.tenancy is None else TenancyState(**{
                n: x[i] for n, x in _fields(rt.tenancy).items()}),
            fusion=None if rt.fusion is None else type(rt.fusion)(**{
                n: own(x) for n, x in _fields(rt.fusion).items()}))

    def _from_local(self, rt: CacheRuntime, views: list[CacheRuntime],
                    outs: list[CacheRuntime]) -> CacheRuntime:
        """The global runtime after a call: the global slab, which the
        store updated in place through the views; index and tenancy leaves
        re-stacked where a body replaced them (their updates make new
        tensors); and shard 0's replicated leaves."""

        def stacked(group, get, join):
            if group is None:
                return None
            out = {}
            for n, x in _fields(group).items():
                parts = [getattr(get(o), n) for o in outs]
                same = all(p is getattr(get(v), n)
                           for p, v in zip(parts, views))
                out[n] = x if same else join(parts)
            return type(group)(**out)
        first = outs[0]
        state = dataclasses.replace(rt.state, ptr=first.state.ptr,
                                    n_inserts=first.state.n_inserts)
        return CacheRuntime(
            state=state, stats=first.stats, policy_state=first.policy_state,
            index_state=stacked(rt.index_state, lambda o: o.index_state,
                                torch.cat),
            tenancy=stacked(rt.tenancy, lambda o: o.tenancy, torch.stack),
            fusion=first.fusion)

    def _spmd(self, runtime: CacheRuntime,
              body: Callable[[CacheRuntime, _MeshComm], tuple[Any,
                                                              CacheRuntime]]
              ) -> tuple[list, list[CacheRuntime], list[CacheRuntime]]:
        """Run ``body(local_runtime, comm)`` on every shard, shard 0 on the
        calling thread, the bodies taking turns between collectives
        (``_Group``). Returns, in shard order, the bodies' first outputs,
        the runtimes they were given and the runtimes they returned;
        ``_from_local`` merges the last. If a body raises, every other
        shard leaves its wait, and the first exception is raised here."""
        s = self.num_shards
        group = _Group(s)
        views = [self._to_local(runtime, i) for i in range(s)]
        results: list = [None] * s
        errors: list[BaseException] = []
        dev = self.mesh.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" \
            else None

        def run(i: int) -> None:
            comm = _MeshComm(i, s, self.local_capacity, group)
            try:
                group.wait_turn(i)
                if stream is None or i == 0:
                    results[i] = body(views[i], comm)
                else:
                    with torch.cuda.stream(stream):
                        results[i] = body(views[i], comm)
                group.pass_turn(i)
            except _Aborted:
                pass
            except BaseException as exc:   # noqa: BLE001 — re-raised below
                errors.append(exc)
                group.abort()

        with self._lock:
            futures = [self._pool.submit(run, i) for i in range(1, s)]
            run(0)
            for f in futures:
                f.result()
        if errors:
            raise errors[0]
        return [r[0] for r in results], views, [r[1] for r in results]

    def _call(self, runtime, body):
        firsts, views, outs = self._spmd(runtime, body)
        return firsts[0], self._from_local(runtime, views, outs)

    # -- sharded methods (same arguments as SemanticCache) -----------------
    def lookup(self, runtime: CacheRuntime, queries: torch.Tensor, now, *,
               update_counters: bool = True,
               tenant_id: torch.Tensor | None = None,
               window: torch.Tensor | None = None,
               window_len: torch.Tensor | None = None
               ) -> tuple[LookupResult, CacheRuntime]:
        return self._call(runtime, lambda rt, comm: self.local.lookup(
            rt, queries, now, update_counters=update_counters,
            tenant_id=tenant_id, window=window, window_len=window_len,
            comm=comm))

    def step(self, runtime: CacheRuntime, queries: torch.Tensor,
             miss_values: torch.Tensor, miss_value_lens: torch.Tensor, now,
             *, source_id: torch.Tensor | None = None,
             peeked: LookupResult | None = None,
             valid: torch.Tensor | None = None,
             tenant_id: torch.Tensor | None = None,
             window: torch.Tensor | None = None,
             window_len: torch.Tensor | None = None
             ) -> tuple[LookupResult, CacheRuntime]:
        """The one fused step on every shard: per-shard lookup, merged
        decision, per-tenant overrides, routed masked insert, stats and
        tenancy updates (DESIGN.md §19.3)."""
        return self._call(runtime, lambda rt, comm: self.local.step(
            rt, queries, miss_values, miss_value_lens, now,
            source_id=source_id, peeked=peeked, valid=valid,
            tenant_id=tenant_id, window=window, window_len=window_len,
            comm=comm))

    def insert(self, runtime: CacheRuntime, queries: torch.Tensor,
               values: torch.Tensor, value_lens: torch.Tensor, now, *,
               source_id: torch.Tensor | None = None,
               mask: torch.Tensor | None = None,
               tenant_id: torch.Tensor | None = None) -> CacheRuntime:
        return self._call(runtime, lambda rt, comm: (None, self.local.insert(
            rt, queries, values, value_lens, now, source_id=source_id,
            mask=mask, tenant_id=tenant_id, comm=comm)))[1]

    def refit(self, runtime: CacheRuntime, now, rng: torch.Generator
              ) -> CacheRuntime:
        """Per-shard index rebuild over each shard's own rows. One seed is
        drawn from ``rng`` (a CPU generator) and folded with each shard id
        into that shard's CPU generator, as ``jax.random.fold_in`` folds
        the key, so shards train independent structures and the card and
        the CPU draw the same rows."""
        base = int(torch.randint(0, 2 ** 62, (), generator=rng))
        gens = [torch.Generator().manual_seed(
            (base + i * 0x9E3779B97F4A7C15) % 2 ** 64)
            for i in range(self.num_shards)]
        return self._call(runtime, lambda rt, comm: (
            None, self.local.refit(rt, now, gens[comm.shard])))[1]

    # -- shard-oblivious methods: delegate to the global view --------------
    def expire(self, runtime: CacheRuntime, now) -> CacheRuntime:
        return self.cache.expire(runtime, now)

    def gather_topk(self, runtime: CacheRuntime, result: LookupResult
                    ) -> dict[str, torch.Tensor]:
        # merged top-k ids are global slot ids, the global slab's rows
        return self.cache.gather_topk(runtime, result)

    def update_policy(self, runtime: CacheRuntime, **kw) -> CacheRuntime:
        return self.cache.update_policy(runtime, **kw)

    def update_band(self, runtime: CacheRuntime, **kw) -> CacheRuntime:
        return self.cache.update_band(runtime, **kw)

    def _maybe_fuse(self, runtime: CacheRuntime, queries: torch.Tensor,
                    window, window_len) -> torch.Tensor:
        return self.cache._maybe_fuse(runtime, queries, window, window_len)

    # -- the reference's legacy entry point ---------------------------------
    def make_lookup_insert(self):
        """The legacy fused lookup+insert entry point, a shim over
        ``step``: ``fused(runtime, queries, miss_values, miss_value_lens,
        source_id, now) -> (runtime, (index, score, hit, values,
        value_lens, source_id))``."""
        def fused(runtime, queries, miss_values, miss_value_lens,
                  source_id, now):
            result, runtime = self.step(
                runtime, queries, miss_values, miss_value_lens, now,
                source_id=source_id)
            return runtime, (result.index, result.score, result.hit,
                             result.values, result.value_lens,
                             result.source_id)
        return fused
