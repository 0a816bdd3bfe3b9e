"""Cache-runtime checkpoints in the format of ``repro.training.checkpoint``.

A runtime is flattened to '/'-joined key paths (``runtime/state/keys`` …
``runtime/stats/inserts``, ``runtime/policy_state``, the index state's
leaves under ``runtime/index_state/`` (none for the exact index;
``centroids``, ``buckets``, ``bucket_valid`` for IVF), on a partitioned
cache ``runtime/tenancy/ptr`` … ``runtime/tenancy/evictions`` and, on a
context-fused one, ``runtime/fusion/context_weight``, ``decay`` and
``temp``), saved as one compressed npz plus a JSON manifest. The keys and dtypes are exactly those
the JAX package writes, so a snapshot taken by either package loads into
the other. A bfloat16 slab is written as float32 (numpy has no bfloat16;
the values are exact and the JAX loader casts them back). A sharded
runtime (``DistributedCache``'s ``ShardedRuntime``) has the same keys: each
shard's rows are read from its device into the shard-major slab, its index
leaves stacked on the leading axis (S·C, ...) and its tenancy leaves
(S, T); ``reshard_runtime`` re-places a snapshot's entries onto another
shard count.

Crash safety: the npz and the manifest are written to a temp file and
published with ``os.replace``, so a crash mid-save leaves the previous
snapshot intact. ``open_checkpoint`` reads every member eagerly and turns
a truncated or corrupt file into one ``CheckpointCorruptError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.context.fusion import FusionState
from repro_torch.core.index import ExactIndex
from repro_torch.core.runtime import CacheRuntime, ShardedRuntime
from repro_torch.core.types import CacheConfig, CacheState, CacheStats
from repro_torch.tenancy.partition import TenancyState

_STATE = tuple(f.name for f in CacheState.__dataclass_fields__.values())
_STATS = tuple(f.name for f in CacheStats.__dataclass_fields__.values())
_TENANCY = tuple(f.name for f in TenancyState.__dataclass_fields__.values())
_FUSION = tuple(f.name for f in FusionState.__dataclass_fields__.values())


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file exists but cannot be read back."""


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def runtime_to_numpy(runtime: CacheRuntime | ShardedRuntime,
                     prefix: str = "runtime") -> dict[str, np.ndarray]:
    """Flatten a runtime to the JAX package's npz key paths; a sharded
    one in its shard-major layout, each shard's rows read from its
    device."""
    if isinstance(runtime, ShardedRuntime):
        runtime = runtime.gather("cpu")
    flat = {f"{prefix}/state/{n}": _to_numpy(getattr(runtime.state, n))
            for n in _STATE}
    flat.update({f"{prefix}/stats/{n}": _to_numpy(getattr(runtime.stats, n))
                 for n in _STATS})
    flat[f"{prefix}/policy_state"] = _to_numpy(runtime.policy_state)
    flat.update({f"{prefix}/index_state/{f.name}":
                 _to_numpy(getattr(runtime.index_state, f.name))
                 for f in dataclasses.fields(runtime.index_state)})
    if runtime.tenancy is not None:
        flat.update({f"{prefix}/tenancy/{n}":
                     _to_numpy(getattr(runtime.tenancy, n))
                     for n in _TENANCY})
    if runtime.fusion is not None:
        flat.update({f"{prefix}/fusion/{n}":
                     _to_numpy(getattr(runtime.fusion, n)) for n in _FUSION})
    return flat


def runtime_from_numpy(flat: dict[str, np.ndarray], config: CacheConfig,
                       device: torch.device, prefix: str = "runtime", *,
                       num_tenants: int | None = None,
                       index=None, fused: bool = False,
                       num_shards: int | None = None) -> CacheRuntime:
    """Rebuild a runtime of ``config`` on ``device`` from flattened arrays;
    ``num_tenants`` is the tenant count of a partitioned cache (None for a
    single-tenant one), ``index`` the cache's index (None: the exact one),
    whose ``init`` gives the index state's leaves, shapes and dtypes, and
    ``fused`` whether the cache is context-fused. ``num_shards`` is the
    shard count of a ``DistributedCache`` (None for an unsharded cache):
    its index leaves are stacked on the leading axis (S·C, ...) and its
    tenancy leaves are (S, T), as the JAX package's. A snapshot without
    ``runtime/fusion/*`` keys gives ``fusion=None`` (the caller keeps its
    fresh weights); one with them restores them. Raises ValueError on a
    missing key, a shape that ``config`` does not give, index state of
    another index type, tenancy state that does not fit ``num_tenants``,
    fusion state for a cache without fusion, and NotImplementedError on
    state of a slice not ported yet."""
    groups = set()
    for k in flat:
        group = k[len(prefix) + 1:].split("/", 1)[0]
        if group not in ("state", "stats", "policy_state", "index_state",
                         "tenancy", "fusion"):
            raise NotImplementedError(
                f"checkpoint key {k!r} belongs to a slice not ported yet")
        groups.add(group)
    if "fusion" in groups and not fused:
        # dropping the weights would change every fused key the snapshot's
        # entries were stored under
        raise ValueError(
            "checkpoint carries context-fusion weights (runtime/fusion/*) "
            "but the cache has no fusion strategy; construct it with "
            "fusion=... to load it")
    if ("tenancy" in groups) != (num_tenants is not None):
        raise ValueError(
            "checkpoint tenancy state does not match the cache: "
            f"{'has' if 'tenancy' in groups else 'lacks'} runtime/tenancy/*"
            f" keys, the cache has {num_tenants or 'no'} tenant(s)")
    n, d, v = config.capacity, config.dim, config.value_len
    shapes = {"keys": (n, d), "values": (n, v), "ptr": (), "n_inserts": ()}
    dtypes = {"keys": config.key_dtype, "values": torch.int32,
              "value_lens": torch.int32, "expiry": torch.float32,
              "valid": torch.bool, "freq": torch.int32,
              "last_used": torch.float32, "inserted_at": torch.float32,
              "source_id": torch.int32, "ptr": torch.int32,
              "n_inserts": torch.int32}

    def get(key: str, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        if key not in flat:
            raise ValueError(f"checkpoint is missing key {key!r}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{shape}")
        return _tensor(arr, device, dtype)

    state = CacheState(**{
        name: get(f"{prefix}/state/{name}", shapes.get(name, (n,)),
                  dtypes[name]) for name in _STATE})
    stats = CacheStats(**{name: get(f"{prefix}/stats/{name}", (),
                                    torch.int32) for name in _STATS})
    pkey = f"{prefix}/policy_state"
    if pkey not in flat:
        raise ValueError(f"checkpoint is missing key {pkey!r}")
    policy_state = get(pkey, tuple(np.shape(flat[pkey])), torch.float32)
    template = (index or ExactIndex()).init(
        config if num_shards is None else dataclasses.replace(
            config, capacity=config.capacity // num_shards), device)
    names = {f.name for f in dataclasses.fields(template)}
    stack = 1 if num_shards is None else num_shards
    saved = {k[len(f"{prefix}/index_state/"):] for k in flat
             if k.startswith(f"{prefix}/index_state/")}
    if saved != names:
        raise ValueError(
            f"checkpoint index state {sorted(saved)} does not match this "
            f"cache's {type(template).__name__} {sorted(names)}; build the "
            "cache with the index the snapshot was taken with")
    index_state = type(template)(**{
        name: get(f"{prefix}/index_state/{name}",
                  _stacked(getattr(template, name).shape, stack),
                  getattr(template, name).dtype) for name in names})
    tenancy = None
    if num_tenants is not None:
        shape = (num_tenants,) if num_shards is None \
            else (num_shards, num_tenants)
        tenancy = TenancyState(**{
            name: get(f"{prefix}/tenancy/{name}", shape, torch.int32)
            for name in _TENANCY})
    fusion = None
    if "fusion" in groups:
        fusion = FusionState(**{
            name: get(f"{prefix}/fusion/{name}", (), torch.float32)
            for name in _FUSION})
    return CacheRuntime(state=state, stats=stats, policy_state=policy_state,
                        index_state=index_state, tenancy=tenancy,
                        fusion=fusion)


def _tensor(arr: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """A saved array as a tensor of ``dtype`` on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bfloat16 slab saved by the JAX package reads back as raw
        # 2-byte records: each is the top half of a float32
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return torch.as_tensor(np.array(arr)).to(device=device, dtype=dtype)


def _stacked(shape: torch.Size, s: int) -> tuple:
    """``shape`` with its leading dim taken ``s`` times (index state of
    ``s`` shards stacked on the leading axis)."""
    return tuple(shape) if not shape else (shape[0] * s, *shape[1:])


def save_checkpoint(path: str, flat: dict[str, np.ndarray],
                    metadata: dict | None = None) -> None:
    """Write ``flat`` to ``path`` (npz) and ``path + '.manifest.json'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # np.savez appends ".npz" to bare string paths but not to file objects,
    # so write the temp through a handle and publish under the real name
    data_path = path if path.endswith(".npz") else path + ".npz"
    tmp_data = data_path + ".tmp"
    try:
        with open(tmp_data, "wb") as f:
            np.savez_compressed(f, **flat)
        os.replace(tmp_data, data_path)
    finally:
        if os.path.exists(tmp_data):
            os.remove(tmp_data)
    manifest = {"keys": sorted(flat), "metadata": metadata or {}}
    tmp_manifest = path + ".manifest.json.tmp"
    try:
        with open(tmp_manifest, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp_manifest, path + ".manifest.json")
    finally:
        if os.path.exists(tmp_manifest):
            os.remove(tmp_manifest)


def open_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Corrupt-safe checkpoint read: every member loaded eagerly."""
    data_path = path if path.endswith(".npz") else path + ".npz"
    try:
        with np.load(data_path) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    except (zipfile.BadZipFile, OSError, EOFError, ValueError, KeyError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint {data_path!r} is truncated or corrupt "
            f"({type(exc).__name__}: {exc}); the snapshot cannot be "
            "restored — delete it and fall back to an older one") from exc


def load_checkpoint(path: str, template):
    """Restore into the structure of ``template``: a tensor, or a dict,
    list, tuple or dataclass of them (None leaves stay None), whose
    '/'-joined key paths are those the JAX package's ``load_checkpoint``
    reads (dict keys, field names, sequence indices). Each leaf comes back
    with the template's dtype, on its device; a missing key raises
    ``CheckpointCorruptError``, a shape that differs ValueError."""
    data = open_checkpoint(path)

    def restore(node, key: str):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            if key not in data:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r} is missing key {key!r} required "
                    "by the restore template")
            arr = data[key]
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} "
                                 f"vs {tuple(node.shape)}")
            return _tensor(arr, node.device, node.dtype)
        prefix = key + "/" if key else ""
        if isinstance(node, dict):
            return {k: restore(v, prefix + str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(restore(v, prefix + str(i))
                              for i, v in enumerate(node))
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                f.name: restore(getattr(node, f.name), prefix + f.name)
                for f in dataclasses.fields(node)})
        raise TypeError(f"cannot restore a {type(node).__name__} at {key!r}")
    return restore(template, "")


def load_checkpoint_flat(path: str) -> dict[str, np.ndarray]:
    """Raw key -> array view of a checkpoint, no template required: the
    entry point for restores across layouts, where the saved per-shard
    tenancy and index leaves differ from the running ones."""
    return open_checkpoint(path)


def reshard_runtime(flat: dict[str, np.ndarray], template: CacheRuntime, *,
                    old_shards: int, new_shards: int, partition=None,
                    prefix: str = "runtime") -> CacheRuntime:
    """Restore a checkpointed runtime onto a *different* shard count
    (DESIGN.md §19.5), the host algorithm of the JAX package's
    ``reshard_runtime``, array for array.

    The slab keeps its global shapes across layouts; only the entries'
    placement (which global row a logical entry occupies under the
    shard-major round robin), the per-shard tenancy leaves and the
    per-shard index state change:

      1. order the live entries by ``(inserted_at, slot)``, the FIFO order
         every ring agrees on;
      2. re-place them round robin into the new layout (per tenant ring
         when partitioned: an old entry's tenant comes from its *local*
         offset through the old layout's per-shard region map);
      3. rebuild ring pointers from the placement counts, put the summed
         tenancy counters on shard 0 (which the sum over shards expects),
         and set the insert clock to the number of entries placed;
      4. keep ``template``'s fresh index state: the caller must refit (the
         saved buckets hold old-placement local slot ids).

    ``template`` is a fresh runtime of the NEW layout; the result is a
    global runtime on its (controller's) device, which
    ``DistributedCache.place`` splits onto a mesh. ``partition`` is the
    *global* ``PartitionMap`` (None when single-tenant). Stats, policy and
    fusion leaves are replicated in every layout and are copied by name
    where their shapes match."""
    if isinstance(template, ShardedRuntime):
        template = template.gather()
    skey = prefix + "/state/"
    g = {k[len(skey):]: np.asarray(v) for k, v in flat.items()
         if k.startswith(skey)}
    n = int(g["valid"].shape[0])
    if n % old_shards or n % new_shards:
        raise ValueError(f"capacity {n} not divisible by shard counts "
                         f"{old_shards} -> {new_shards}")
    l_old, l_new = n // old_shards, n // new_shards
    live = np.nonzero(g["valid"].astype(bool))[0]
    order = live[np.lexsort((live, g["inserted_at"][live]))]
    e = int(order.shape[0])

    def like(arr, leaf: torch.Tensor) -> torch.Tensor:
        return _tensor(arr, leaf.device, leaf.dtype)

    tenancy = template.tenancy
    if partition is None:
        r = np.arange(e)
        dst = (r % new_shards) * l_new + r // new_shards
    else:
        sizes = np.asarray(partition.sizes, dtype=np.int64)
        if np.any(sizes % old_shards) or np.any(sizes % new_shards):
            raise ValueError(f"region sizes {partition.sizes} must divide "
                             f"both shard counts {old_shards}, {new_shards}")
        old_edges = np.cumsum(sizes // old_shards)
        new_sizes = sizes // new_shards
        new_starts = np.asarray(partition.starts, dtype=np.int64) \
            // new_shards
        owner = np.searchsorted(old_edges, order % l_old, side="right")
        dst = np.empty((e,), dtype=np.int64)
        t_count = np.zeros((len(partition),), dtype=np.int64)
        for t in range(len(partition)):
            idx = np.nonzero(owner == t)[0]      # already in FIFO order
            r = np.arange(idx.size)
            dst[idx] = ((r % new_shards) * l_new + new_starts[t]
                        + r // new_shards)
            t_count[t] = idx.size
        s_idx = np.arange(new_shards)[:, None]
        fill = np.maximum(t_count[None, :] - s_idx, 0)
        fill = -(-fill // new_shards)            # ceil div
        ptr = (fill % new_sizes[None, :]).astype(np.int32)

        def attributed(name: str) -> np.ndarray:
            arr = np.asarray(flat[f"{prefix}/tenancy/{name}"])
            tot = arr.reshape(-1, arr.shape[-1]).sum(axis=0).astype(np.int32)
            if new_shards == 1:
                return tot
            out = np.zeros((new_shards, tot.shape[0]), dtype=np.int32)
            out[0] = tot                          # the sum stays exact
            return out

        tl = template.tenancy
        tenancy = TenancyState(
            ptr=like(ptr if new_shards > 1 else ptr[0], tl.ptr),
            **{name: like(attributed(name), getattr(tl, name))
               for name in _TENANCY if name != "ptr"})

    fields = {}
    for name, arr in g.items():
        tmpl = getattr(template.state, name)
        if arr.ndim == 0 or arr.shape[0] != n:
            continue                              # clock scalars, below
        out = _to_numpy(tmpl).copy()
        if arr.dtype.kind == "V":
            arr = _tensor(arr, "cpu", torch.float32).numpy()
        out[dst] = arr[order]
        fields[name] = like(out, tmpl)
    ring_local = partition is None and new_shards == 1
    st = template.state
    state = dataclasses.replace(
        st, ptr=like(np.int32(e % n if ring_local else 0), st.ptr),
        n_inserts=like(np.int32(e), st.n_inserts), **fields)

    def copied(key: str, leaf: torch.Tensor) -> torch.Tensor:
        arr = flat.get(key)
        if arr is not None and tuple(np.shape(arr)) == tuple(leaf.shape):
            return like(arr, leaf)
        return leaf

    def copy_group(group, name: str):
        if group is None:
            return None
        return type(group)(**{
            f.name: copied(f"{prefix}/{name}/{f.name}",
                           getattr(group, f.name))
            for f in dataclasses.fields(group)})

    return template.replace(
        state=state, tenancy=tenancy,
        stats=copy_group(template.stats, "stats"),
        policy_state=copied(f"{prefix}/policy_state", template.policy_state),
        fusion=copy_group(template.fusion, "fusion"))


def read_metadata(path: str) -> dict:
    """The manifest's metadata of the snapshot at ``path`` ({} if none)."""
    manifest = path + ".manifest.json"
    if not os.path.exists(manifest):
        return {}
    with open(manifest) as f:
        return json.load(f).get("metadata", {})
