"""Static slab partition map + per-tenant runtime state (PyTorch port of
``repro.tenancy.partition``).

``PartitionMap`` is the static half of tenancy: a frozen, hashable record
of which contiguous slab region each tenant owns and which similarity
threshold (if any) overrides the cache-wide policy for it. It is fixed at
``SemanticCache`` construction like the index and policy plugins; the
per-row ``tenant_id`` tensor is the only per-batch tenancy input.

``TenancyState`` is the dynamic half: per-tenant ring pointers and
accounting counters, one more leaf group of the ``CacheRuntime``, saved
and restored with the slab.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """Contiguous per-tenant slab regions. Tenant ``t`` owns slots
    ``[starts[t], starts[t] + sizes[t])``; regions are disjoint and cover
    the slab exactly.

    ``thresholds[t] < 0`` means "no override" (use the policy's decision);
    ``band_lo[t] < 0`` likewise means "no override" for the near-hit band's
    lower edge. ``band_lo`` defaults to all-no-override.
    """

    names: tuple[str, ...]
    starts: tuple[int, ...]
    sizes: tuple[int, ...]
    thresholds: tuple[float, ...]
    capacity: int
    band_lo: tuple[float, ...] = ()

    def __post_init__(self):
        if not self.band_lo:
            object.__setattr__(self, "band_lo", (-1.0,) * len(self.names))
        if not (len(self.names) == len(self.starts) == len(self.sizes)
                == len(self.thresholds) == len(self.band_lo)):
            raise ValueError("partition field lengths disagree")
        if sum(self.sizes) != self.capacity:
            raise ValueError(f"regions sum to {sum(self.sizes)}, "
                             f"capacity is {self.capacity}")
        acc = 0
        for s, z in zip(self.starts, self.sizes):
            if s != acc or z < 1:
                raise ValueError("regions must be contiguous, in order and "
                                 "non-empty")
            acc += z

    def __len__(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{self.names}") from None

    def region(self, name: str) -> tuple[int, int]:
        i = self.index(name)
        return self.starts[i], self.sizes[i]

    def manifest(self) -> dict:
        """JSON-able layout record, written into a checkpoint manifest and
        compared on restore. ``band_lo`` appears only when some tenant
        overrides the band edge, as in the JAX package, so the manifests of
        the two packages are equal."""
        m = {"names": list(self.names), "starts": list(self.starts),
             "sizes": list(self.sizes),
             "thresholds": list(self.thresholds)}
        if any(b >= 0.0 for b in self.band_lo):
            m["band_lo"] = list(self.band_lo)
        return m

    def slot_owner(self) -> np.ndarray:
        """(capacity,) int32: owning tenant of every slab slot."""
        return _slot_owner(self.starts, self.sizes, self.capacity)

    # -- per-tenant tensors on a device (built once per device) ----------- #
    def starts_array(self, device) -> torch.Tensor:
        return _constant(self.starts, torch.int32, torch.device(device))

    def sizes_array(self, device) -> torch.Tensor:
        return _constant(self.sizes, torch.int32, torch.device(device))

    def thresholds_array(self, device) -> torch.Tensor:
        """(T,) float32; negative entries mean "no override"."""
        return _constant(self.thresholds, torch.float32, torch.device(device))

    def band_lo_array(self, device) -> torch.Tensor:
        """(T,) float32 near-band lower-edge overrides; negative entries
        mean "no override" (use the band policy's τ_lo)."""
        return _constant(self.band_lo, torch.float32, torch.device(device))


@functools.lru_cache(maxsize=64)
def _slot_owner(starts: tuple[int, ...], sizes: tuple[int, ...],
                capacity: int) -> np.ndarray:
    owner = np.empty((capacity,), dtype=np.int32)
    for t, (s, z) in enumerate(zip(starts, sizes)):
        owner[s:s + z] = t
    return owner


@functools.lru_cache(maxsize=256)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device
              ) -> torch.Tensor:
    """A read-only per-tenant table on ``device``; callers index it and
    never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass
class TenancyState:
    """Per-tenant mutable state, one ``CacheRuntime`` leaf group.

    Leaves (all (T,) int32, T = number of tenants):
      ptr       — ring insert pointer, an offset within the tenant's region
                  (the global ``CacheState.ptr`` is unused under tenancy);
      lookups   — committed lookups per tenant;
      hits      — committed hits per tenant;
      inserts   — rows written per tenant;
      evictions — inserts that overwrote a live entry. A tenant can only
                  ever evict itself: regions are disjoint.
    """

    ptr: torch.Tensor
    lookups: torch.Tensor
    hits: torch.Tensor
    inserts: torch.Tensor
    evictions: torch.Tensor

    @staticmethod
    def zeros(num_tenants: int, device: str | torch.device = "cuda"
              ) -> "TenancyState":
        def z():
            return torch.zeros((num_tenants,), dtype=torch.int32,
                               device=device)
        return TenancyState(ptr=z(), lookups=z(), hits=z(), inserts=z(),
                            evictions=z())

    @property
    def num_tenants(self) -> int:
        return self.ptr.shape[-1]

    def reduced(self) -> "TenancyState":
        """Collapse per-shard stacking ((S, T) leaves) to the (T,) counters
        by summing over the leading axes; a (T,) state comes back
        unchanged. The summed ``ptr`` is total ring fill, not a ring
        offset."""
        if self.ptr.dim() == 1:
            return self

        def s(x):
            return x.sum(dim=tuple(range(x.dim() - 1)), dtype=torch.int32)
        return TenancyState(ptr=s(self.ptr), lookups=s(self.lookups),
                            hits=s(self.hits), inserts=s(self.inserts),
                            evictions=s(self.evictions))
