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
one call runs at a time.

Devices. The mesh names one device a shard (``make_mesh(...,
device=[...])``, as ``jax.make_mesh(..., devices=)``), or one device for
all of them; shard 0's is the controller's: queries arrive there and
results leave from there. Each body runs under ``torch.cuda.device`` of
its shard's device, on that device's stream (the caller's current stream
of it: shards of one device share it, as they take turns). An exchange
moves each part to the receiving shard's device: a CUDA producer records
an event on its stream, a CUDA consumer's stream waits on it and copies
with ``non_blocking=True``, a CPU consumer waits on the event and copies.
The replicated operands of a call (queries, masks, tenant ids, windows, a
peeked result) go to each shard's device once per call. On one device
every such move is the tensor itself: one code path, in which a copy is a
view.

Slot ids are shard-major: global slot ``g`` lives on shard
``g // local_capacity`` at local row ``g % local_capacity``; ``slab_rows``
fetches global rows from their owners (``gather_topk``, explain, the
engine's canonical session keys).

State (``ShardedRuntime``, per-shard runtimes kept between calls; the
layout the reference's global arrays have, DESIGN.md §19.3):
  * shard ``i``'s ``CacheState`` holds its ``local_capacity`` rows on its
    device; the store's in-place updates write into them;
  * its index state is its own (C, ...) leaves, e.g. IVF centroids (C, d)
    and buckets (C, cap) of *local* slot ids (the global view stacks them
    (S·C, ...));
  * its ``TenancyState`` row is (T,) (globally (S, T));
  * ``CacheStats``, policy state, fusion weights and the ``ptr`` /
    ``n_inserts`` clock are replicated: a call hands each shard body shard
    0's copy on its device, and after the call shard 0's is the cache's.
Checkpoints read each shard's rows from its device into the shard-major
file (``ShardedRuntime.gather``); ``place`` splits a global runtime onto
the shards' devices.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import math
import threading
import weakref
from typing import Any, Callable, Sequence

import torch

from repro_torch import prng
from repro_torch.core import store
from repro_torch.core.cache import (SemanticCache, _LocalComm,
                                   topk_payload)
from repro_torch.core.runtime import (_CLOCK, CacheRuntime, ShardedRuntime,
                                     _moved)
from repro_torch.core.types import LookupResult, resolve_device
from repro_torch.tenancy.partition import TenancyState


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _resolved(device) -> torch.device:
    """``resolve_device`` with a CUDA device's index made explicit."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The port's counterpart of ``jax.sharding.Mesh``: named axes of
    shards. ``shape`` maps each axis name to its size, as ``Mesh.shape``
    does; shard ``i`` (shard-major order) sits on ``devices[i]``, and
    ``device``, shard 0's, is the controller's."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device=None) -> ShardMesh:
    """A mesh of ``prod(shape)`` shards with the named axes, the
    counterpart of ``jax.make_mesh``. ``device`` is one device for every
    shard, or a sequence of ``prod(shape)`` devices in shard-major order
    (``jax.make_mesh(..., devices=)``), which may repeat and mix types
    (``["cuda:0", "cpu", "cuda:0", "cpu"]``). ``device=None`` means CUDA,
    as at every entry point."""
    shape, names = tuple(int(x) for x in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} must "
                         "pair up, one distinct name per axis")
    if any(x < 1 for x in shape):
        raise ValueError(f"mesh axis sizes must be positive: {shape}")
    n = math.prod(shape)
    if isinstance(device, (list, tuple)):
        if len(device) != n:
            raise ValueError(f"a mesh of shape {shape} has {n} shards; got "
                             f"{len(device)} devices")
        devs = tuple(_resolved(d) for d in device)
    else:
        devs = (_resolved(device),) * n
    return ShardMesh(names, shape, devs)


def _on(x, device: torch.device):
    """A call operand on ``device``: a tensor, or a ``LookupResult`` (a
    peeked result), moved; anything else as it is. On the tensor's own
    device that is the tensor itself."""
    return _moved(x, device) if isinstance(x, (torch.Tensor, LookupResult)) \
        else x


def _received(value, event, device: torch.device):
    """An exchanged part (a tensor or a tuple of them) on the receiving
    shard's ``device``: a CUDA consumer's stream waits on the producer's
    event and copies without blocking; a CPU consumer waits on the event
    and copies."""
    def move(x):
        if not isinstance(x, torch.Tensor) or _same_device(x.device, device):
            return x
        if device.type == "cuda":
            if event is not None:
                torch.cuda.current_stream(device).wait_event(event)
            return x.to(device, non_blocking=True)
        if event is not None:
            event.synchronize()
        return x.to(device)
    return tuple(move(x) for x in value) if isinstance(value, tuple) \
        else move(value)


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

    def __init__(self, devices: Sequence[torch.device]):
        n = self.n = len(devices)
        self.devices = tuple(devices)
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
        self.device = group.devices[shard]
        # an event is recorded only where another shard's device reads
        self._remote = any(not _same_device(d, self.device)
                           for d in group.devices)
        self._round = 0

    def all_gather(self, value) -> list:
        """Every shard's ``value`` (a tensor or a tuple of them), in shard
        order, each on this shard's device (a barrier)."""
        g = self.group
        buf = g.buffers[self._round % 2]
        self._round += 1
        event = None
        if self._remote and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        buf[self.shard] = (value, event)
        g.pass_turn(self.shard)
        g.wait_turn(self.shard)
        return [v if i == self.shard else _received(v, ev, self.device)
                for i, (v, ev) in enumerate(buf)]

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


def _stream_context(device: torch.device, streams: dict
                    ) -> contextlib.ExitStack:
    """A shard body's context: every CUDA device's stream of the call (so
    a copy between devices orders on the streams the bodies use) and, for
    a CUDA shard, its device."""
    ctx = contextlib.ExitStack()
    for stream in streams.values():
        ctx.enter_context(torch.cuda.stream(stream))
    if device.type == "cuda":
        ctx.enter_context(torch.cuda.device(device))
    return ctx


@dataclasses.dataclass(frozen=True)
class DistributedCache:
    """Capacity-sharded ``SemanticCache`` with the same method surface.

    ``cache`` is the *global* description (full capacity, global
    partition); each shard runs a derived shard-local cache (capacity and
    regions divided by the shard count, the same index, policy and fusion
    plugins) with its ``_MeshComm``. Of the methods that never exchange,
    ``expire`` runs on every shard (the expired counts summed),
    ``gather_topk`` fetches each row from its owner, and
    ``update_policy``, ``update_band`` and ``_maybe_fuse``, which read and
    write replicated leaves only, run on the controller's copy, the one
    the next call hands every shard.

    ``config`` / ``partition`` / ``policy`` / ``index`` / ``fusion`` mirror
    the inner cache, and ``lookup`` / ``step`` / ``insert`` / ``refit``
    take the same arguments, so ``CachedEngine`` and the async scheduler
    drive a mesh without a special case (DESIGN.md §19.4). The runtime is
    a ``ShardedRuntime``; the one passed to a call must not be used after
    it, as with ``SemanticCache``.
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

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """Each shard's device, in shard order: the mesh device at the
        shard's coordinates on the split axes and 0 on the others (the
        other axes' devices hold replicas a call does not run)."""
        names, sizes = self.mesh.axis_names, self.mesh.axis_sizes
        out = []
        for coords in itertools.product(*(range(n) for n in sizes)):
            if any(c for a, c in zip(names, coords)
                   if a not in self.cache_axes):
                continue
            flat = 0
            for c, n in zip(coords, sizes):
                flat = flat * n + c
            out.append(self.mesh.devices[flat])
        return tuple(out)

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
            raise ValueError(f"device {dev} is not the mesh's controller "
                             f"device {self.mesh.device} (shard 0's)")
        return self.mesh.device

    def init(self, device=None) -> ShardedRuntime:
        """Fresh sharded runtime: each shard's local init on its device
        (``device``, if given, must be the controller's). The index init is
        deterministic and the replicated leaves start equal, so this is the
        reference's global init cut into shards."""
        self._device(device)
        return ShardedRuntime(tuple(self.local.init(d)
                                    for d in self.devices))

    def place(self, runtime: CacheRuntime) -> ShardedRuntime:
        """A global runtime (a checkpoint's: (N, ...) slab, (S·C, ...)
        index and (S, T) tenancy leaves, checked) split onto the shards'
        devices, each part contiguous; the replicated leaves copied to
        every shard."""
        s, n, lc = self.num_shards, self.config.capacity, self.local_capacity

        def check(group, bad, what):
            for name, x in ({} if group is None else _fields(group)).items():
                if x.dim() and bad(x.shape[0]):
                    raise ValueError(f"{what} leaf {name!r} has leading dim "
                                     f"{x.shape[0]}, not the layout of "
                                     f"{s} shard(s)")
        check(runtime.state, lambda m: m != n, "slab")
        check(runtime.index_state, lambda m: m % s, "index")
        check(runtime.tenancy, lambda m: m != s, "tenancy")

        def part(group, dev, cut=lambda x: x):
            if group is None:
                return None
            return type(group)(**{name: cut(x).to(dev).contiguous()
                                  for name, x in _fields(group).items()})

        def shard(i, dev):
            def rows(x):
                m = x.shape[0] // s
                return x[i * m:(i + 1) * m]
            return CacheRuntime(
                state=part(runtime.state, dev, lambda x: x if x.dim() == 0
                           else x[i * lc:(i + 1) * lc]),
                stats=part(runtime.stats, dev),
                policy_state=runtime.policy_state.to(dev).contiguous(),
                index_state=part(runtime.index_state, dev, rows),
                tenancy=part(runtime.tenancy, dev, lambda x: x[i]),
                fusion=part(runtime.fusion, dev))
        return ShardedRuntime(tuple(shard(i, d)
                                    for i, d in enumerate(self.devices)))

    # -- the shards' runtimes in a call ------------------------------------
    def _to_local(self, rt: ShardedRuntime, i: int) -> CacheRuntime:
        """Shard ``i``'s runtime for a call: its own slab, index and
        tenancy leaves, and shard 0's replicated leaves on its device (on
        shard 0's device, those very tensors)."""
        first, own, dev = rt.shards[0], rt.shards[i], self.devices[i]
        state = dataclasses.replace(
            own.state, **{n: getattr(first.state, n).to(dev)
                          for n in _CLOCK})
        return own.replace(state=state, stats=_moved(first.stats, dev),
                           policy_state=first.policy_state.to(dev),
                           fusion=_moved(first.fusion, dev))

    def _spmd(self, runtime: ShardedRuntime,
              body: Callable[[CacheRuntime, _MeshComm], tuple[Any,
                                                              CacheRuntime]],
              operands: dict | None = None
              ) -> tuple[list, list[CacheRuntime], list[CacheRuntime]]:
        """Run ``body(local_runtime, comm, **operands)`` on every shard,
        shard 0 on the calling thread, the bodies taking turns between
        collectives (``_Group``), each under its device on its device's
        stream, with ``operands`` moved to its device. Returns, in shard
        order, the bodies' first outputs, the runtimes they were given and
        the runtimes they returned, which are the shards' runtimes after
        the call. If a body raises, every other shard leaves its wait, and
        the first exception is raised here."""
        devs = self.devices
        s = len(devs)
        group = _Group(devs)
        views = [self._to_local(runtime, i) for i in range(s)]
        results: list = [None] * s
        errors: list[BaseException] = []
        streams = {d: torch.cuda.current_stream(d) for d in devs
                   if d.type == "cuda"}
        operands = operands or {}

        def run(i: int) -> None:
            comm = _MeshComm(i, s, self.local_capacity, group)
            try:
                group.wait_turn(i)
                with _stream_context(devs[i], streams):
                    ops = {n: _on(x, devs[i]) for n, x in operands.items()}
                    results[i] = body(views[i], comm, **ops)
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

    def _call(self, runtime, body, **operands):
        firsts, _, outs = self._spmd(runtime, body, operands)
        return firsts[0], ShardedRuntime(tuple(outs))

    # -- sharded methods (same arguments as SemanticCache) -----------------
    def lookup(self, runtime: ShardedRuntime, queries: torch.Tensor, now, *,
               update_counters: bool = True,
               tenant_id: torch.Tensor | None = None,
               window: torch.Tensor | None = None,
               window_len: torch.Tensor | None = None
               ) -> tuple[LookupResult, ShardedRuntime]:
        return self._call(runtime, lambda rt, comm, **o: self.local.lookup(
            rt, o["queries"], o["now"], update_counters=update_counters,
            tenant_id=o["tenant_id"], window=o["window"],
            window_len=o["window_len"], comm=comm),
            queries=queries, now=now, tenant_id=tenant_id, window=window,
            window_len=window_len)

    def step(self, runtime: ShardedRuntime, queries: torch.Tensor,
             miss_values: torch.Tensor, miss_value_lens: torch.Tensor, now,
             *, source_id: torch.Tensor | None = None,
             peeked: LookupResult | None = None,
             valid: torch.Tensor | None = None,
             tenant_id: torch.Tensor | None = None,
             window: torch.Tensor | None = None,
             window_len: torch.Tensor | None = None
             ) -> tuple[LookupResult, ShardedRuntime]:
        """The one fused step on every shard: per-shard lookup, merged
        decision, per-tenant overrides, routed masked insert, stats and
        tenancy updates (DESIGN.md §19.3)."""
        return self._call(runtime, lambda rt, comm, **o: self.local.step(
            rt, o["queries"], o["miss_values"], o["miss_value_lens"],
            o["now"], source_id=o["source_id"], peeked=o["peeked"],
            valid=o["valid"], tenant_id=o["tenant_id"], window=o["window"],
            window_len=o["window_len"], comm=comm),
            queries=queries, miss_values=miss_values,
            miss_value_lens=miss_value_lens, now=now, source_id=source_id,
            peeked=peeked, valid=valid, tenant_id=tenant_id, window=window,
            window_len=window_len)

    def insert(self, runtime: ShardedRuntime, queries: torch.Tensor,
               values: torch.Tensor, value_lens: torch.Tensor, now, *,
               source_id: torch.Tensor | None = None,
               mask: torch.Tensor | None = None,
               tenant_id: torch.Tensor | None = None) -> ShardedRuntime:
        return self._call(runtime, lambda rt, comm, **o: (
            None, self.local.insert(
                rt, o["queries"], o["values"], o["value_lens"], o["now"],
                source_id=o["source_id"], mask=o["mask"],
                tenant_id=o["tenant_id"], comm=comm)),
            queries=queries, values=values, value_lens=value_lens, now=now,
            source_id=source_id, mask=mask, tenant_id=tenant_id)[1]

    def refit(self, runtime: ShardedRuntime, now, rng) -> ShardedRuntime:
        """Per-shard index rebuild over each shard's own rows, each shard
        drawing from ``prng.fold_in(rng, shard id)`` as the reference
        folds its key, so shards train independent structures; keys are
        host values, so the card and the CPU draw the same rows."""
        keys = [prng.fold_in(rng, i) for i in range(self.num_shards)]
        return self._call(runtime, lambda rt, comm, **o: (
            None, self.local.refit(rt, o["now"], keys[comm.shard])),
            now=now)[1]

    def expire(self, runtime: ShardedRuntime, now) -> ShardedRuntime:
        """Each shard expires its own rows; the expired counts are summed
        into the replicated stats."""
        def body(rt, comm, now):
            state, n = store.expire(rt.state, now)
            total = torch.stack(comm.all_gather(n)).sum(dtype=torch.int32)
            stats = dataclasses.replace(
                rt.stats,
                expired_evictions=rt.stats.expired_evictions + total)
            return None, rt.replace(state=state, stats=stats)
        return self._call(runtime, body, now=now)[1]

    # -- global rows and replicated leaves ---------------------------------
    def slab_rows(self, runtime: ShardedRuntime, name: str,
                  idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global slot ids >= 0, any shape, on the
        controller's device) of the slab leaf ``name``, each fetched from
        the shard that owns it, on the controller's device."""
        lc, ctrl = self.local_capacity, self.mesh.device
        idx = idx.to(torch.int64)
        out = None
        for i, (shard, dev) in enumerate(zip(runtime.shards, self.devices)):
            mine = idx // lc == i
            local = torch.where(mine, idx % lc, 0).to(dev)
            rows = getattr(shard.state, name)[local].to(ctrl)
            if out is None:
                out = rows
                continue
            mine = mine.reshape(mine.shape + (1,) * (rows.dim()
                                                     - mine.dim()))
            out = torch.where(mine, rows, out)
        return out

    def gather_topk(self, runtime: ShardedRuntime, result: LookupResult
                    ) -> dict[str, torch.Tensor]:
        # merged top-k ids are global slot ids: each row from its owner
        return topk_payload(result, lambda name, idx: self.slab_rows(
            runtime, name, idx))

    def _controller(self, runtime: ShardedRuntime, first: CacheRuntime
                    ) -> ShardedRuntime:
        return ShardedRuntime((first,) + tuple(runtime.shards[1:]))

    def update_policy(self, runtime: ShardedRuntime, **kw) -> ShardedRuntime:
        return self._controller(runtime, self.local.update_policy(
            runtime.shards[0], **kw))

    def update_band(self, runtime: ShardedRuntime, **kw) -> ShardedRuntime:
        return self._controller(runtime, self.local.update_band(
            runtime.shards[0], **kw))

    def _maybe_fuse(self, runtime: ShardedRuntime, queries: torch.Tensor,
                    window, window_len) -> torch.Tensor:
        return self.local._maybe_fuse(runtime.shards[0], queries, window,
                                      window_len)

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
