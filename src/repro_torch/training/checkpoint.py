"""Cache-runtime checkpoints in the format of ``repro.training.checkpoint``.

A runtime is flattened to '/'-joined key paths (``runtime/state/keys`` …
``runtime/stats/inserts``, ``runtime/policy_state`` and, on a partitioned
cache, ``runtime/tenancy/ptr`` … ``runtime/tenancy/evictions``), saved as
one compressed npz plus a JSON manifest. The keys and dtypes are exactly those
the JAX package writes, so a snapshot taken by either package loads into
the other. A bfloat16 slab is written as float32 (numpy has no bfloat16;
the values are exact and the JAX loader casts them back).

Crash safety: the npz and the manifest are written to a temp file and
published with ``os.replace``, so a crash mid-save leaves the previous
snapshot intact. ``open_checkpoint`` reads every member eagerly and turns
a truncated or corrupt file into one ``CheckpointCorruptError``.
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.core.index import ExactState
from repro_torch.core.runtime import CacheRuntime
from repro_torch.core.types import CacheConfig, CacheState, CacheStats
from repro_torch.tenancy.partition import TenancyState

_STATE = tuple(f.name for f in CacheState.__dataclass_fields__.values())
_STATS = tuple(f.name for f in CacheStats.__dataclass_fields__.values())
_TENANCY = tuple(f.name for f in TenancyState.__dataclass_fields__.values())


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file exists but cannot be read back."""


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def runtime_to_numpy(runtime: CacheRuntime, prefix: str = "runtime"
                     ) -> dict[str, np.ndarray]:
    """Flatten a runtime to the JAX package's npz key paths."""
    if not isinstance(runtime.index_state, ExactState):
        raise NotImplementedError("only the exact index is ported")
    flat = {f"{prefix}/state/{n}": _to_numpy(getattr(runtime.state, n))
            for n in _STATE}
    flat.update({f"{prefix}/stats/{n}": _to_numpy(getattr(runtime.stats, n))
                 for n in _STATS})
    flat[f"{prefix}/policy_state"] = _to_numpy(runtime.policy_state)
    if runtime.tenancy is not None:
        flat.update({f"{prefix}/tenancy/{n}":
                     _to_numpy(getattr(runtime.tenancy, n))
                     for n in _TENANCY})
    return flat


def runtime_from_numpy(flat: dict[str, np.ndarray], config: CacheConfig,
                       device: torch.device, prefix: str = "runtime", *,
                       num_tenants: int | None = None) -> CacheRuntime:
    """Rebuild a runtime of ``config`` on ``device`` from flattened arrays;
    ``num_tenants`` is the tenant count of a partitioned cache (None for a
    single-tenant one). Raises ValueError on a missing key, a shape that
    ``config`` does not give or tenancy state that does not fit
    ``num_tenants``, and NotImplementedError on state of a slice not ported
    yet."""
    groups = set()
    for k in flat:
        group = k[len(prefix) + 1:].split("/", 1)[0]
        if group not in ("state", "stats", "policy_state", "tenancy"):
            raise NotImplementedError(
                f"checkpoint key {k!r} belongs to a slice not ported yet")
        groups.add(group)
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
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            # a bfloat16 slab saved by the JAX package reads back as raw
            # 2-byte records: each is the top half of a float32
            arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        return torch.as_tensor(np.array(arr)).to(device=device, dtype=dtype)

    state = CacheState(**{
        name: get(f"{prefix}/state/{name}", shapes.get(name, (n,)),
                  dtypes[name]) for name in _STATE})
    stats = CacheStats(**{name: get(f"{prefix}/stats/{name}", (),
                                    torch.int32) for name in _STATS})
    pkey = f"{prefix}/policy_state"
    if pkey not in flat:
        raise ValueError(f"checkpoint is missing key {pkey!r}")
    policy_state = get(pkey, tuple(np.shape(flat[pkey])), torch.float32)
    tenancy = None
    if num_tenants is not None:
        tenancy = TenancyState(**{
            name: get(f"{prefix}/tenancy/{name}", (num_tenants,),
                      torch.int32) for name in _TENANCY})
    return CacheRuntime(state=state, stats=stats, policy_state=policy_state,
                        index_state=ExactState(), tenancy=tenancy)


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


def read_metadata(path: str) -> dict:
    """The manifest's metadata of the snapshot at ``path`` ({} if none)."""
    manifest = path + ".manifest.json"
    if not os.path.exists(manifest):
        return {}
    with open(manifest) as f:
        return json.load(f).get("metadata", {})
