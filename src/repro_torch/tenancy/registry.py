"""Tenant registry — the host-side source of truth for multi-tenant serving
(plain-Python copy of ``repro.tenancy.registry``).

A tenant is an isolation domain sharing one device-resident cache: a
product surface, a customer org, a user cohort. The registry holds the
static per-tenant knobs — capacity share (or a hard slot quota), a
deficit-round-robin admission weight, and optional per-tenant threshold
and near-band overrides — and compiles them into a ``PartitionMap`` that
splits the one slab into contiguous per-tenant regions.
"""
from __future__ import annotations

import dataclasses

from repro_torch.tenancy.partition import PartitionMap

#: Threshold sentinel: "no override, use the cache-wide policy".
NO_OVERRIDE = -1.0


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Static per-tenant configuration.

    Attributes:
      name: tenant identifier (the ``Request.tenant`` routing key).
      share: relative capacity share; the slab's free capacity (after hard
        quotas) is split proportionally to ``share`` across quota-less
        tenants.
      weight: deficit-round-robin admission weight (scheduler quantum):
        a weight-2 tenant gets twice the micro-batch slots of a weight-1
        tenant under contention.
      quota: hard slab-slot cap. ``None`` = proportional ``share`` sizing.
      threshold: per-tenant cosine hit-threshold override; ``None`` = use
        the cache-wide policy's threshold (a stricter tenant can demand
        higher-precision hits without forking the compiled step).
      band_lo: per-tenant near-hit band lower-edge override; ``None`` =
        use the band policy's τ_lo. The band's *upper*
        edge is definitionally the tenant's effective hit threshold, so a
        tenant overrides both edges via ``threshold`` + ``band_lo``.
    """

    name: str
    share: float = 1.0
    weight: float = 1.0
    quota: int | None = None
    threshold: float | None = None
    band_lo: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.share <= 0 or self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: share and weight must "
                             "be positive")
        if self.quota is not None and self.quota <= 0:
            raise ValueError(f"tenant {self.name!r}: quota must be positive")
        if self.threshold is not None and not 0.0 <= self.threshold <= 1.0:
            raise ValueError(f"tenant {self.name!r}: threshold must be "
                             "within [0, 1]")
        if self.band_lo is not None:
            if not 0.0 <= self.band_lo <= 1.0:
                raise ValueError(f"tenant {self.name!r}: band_lo must be "
                                 "within [0, 1]")
            if self.threshold is not None and self.band_lo > self.threshold:
                raise ValueError(f"tenant {self.name!r}: band_lo must not "
                                 "exceed the hit threshold")


@dataclasses.dataclass(frozen=True)
class TenantRegistry:
    """Ordered, immutable collection of tenants.

    Tenant *index* (position in ``tenants``) is the device-side id threaded
    through the compiled step; tenant *name* is the host-side routing key.
    """

    tenants: tuple[TenantSpec, ...]

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("registry needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")

    @staticmethod
    def uniform(names: "tuple[str, ...] | list[str]") -> "TenantRegistry":
        """Equal shares, equal weights, no overrides."""
        return TenantRegistry(tuple(TenantSpec(name=n) for n in names))

    def __len__(self) -> int:
        return len(self.tenants)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.tenants)

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown tenant {name!r}; registered: {self.names}") from None

    def spec(self, name: str) -> TenantSpec:
        return self.tenants[self.index(name)]

    def weights(self) -> dict[str, float]:
        """DRR admission weights by tenant name (scheduler input)."""
        return {t.name: t.weight for t in self.tenants}

    # -- partition construction ------------------------------------------ #
    def partition(self, capacity: int) -> PartitionMap:
        """Split ``capacity`` slab slots into contiguous per-tenant regions.

        Hard quotas are honoured first; the remaining slots are split
        proportionally to ``share`` with largest-remainder rounding, so the
        regions always sum to exactly ``capacity`` and every tenant gets at
        least one slot.
        """
        n = len(self.tenants)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} tenants")
        sizes = [0] * n
        free = capacity
        quota_idx = [i for i, t in enumerate(self.tenants)
                     if t.quota is not None]
        elastic = [i for i, t in enumerate(self.tenants) if t.quota is None]
        for k, i in enumerate(quota_idx):
            # reserve one slot for every tenant not yet sized — later quota
            # tenants AND all elastic ones, wherever they appear in the
            # declaration order (the allocation must not depend on order)
            unsized_others = (len(quota_idx) - k - 1) + len(elastic)
            sizes[i] = min(self.tenants[i].quota,
                           max(free - unsized_others, 1))
            free -= sizes[i]
        if elastic:
            total_share = sum(self.tenants[i].share for i in elastic)
            exact = [free * self.tenants[i].share / total_share
                     for i in elastic]
            floors = [max(1, int(x)) for x in exact]
            rem = free - sum(floors)
            # largest fractional remainder first; ties broken by position
            order = sorted(range(len(elastic)),
                           key=lambda j: (-(exact[j] - int(exact[j])), j))
            j = 0
            while rem > 0:
                floors[order[j % len(order)]] += 1
                j += 1
                rem -= 1
            while rem < 0:                 # floors over-shot (tiny regions)
                k = max(range(len(floors)), key=lambda j: floors[j])
                floors[k] -= 1
                rem += 1
            for i, s in zip(elastic, floors):
                sizes[i] = s
        if min(sizes) < 1 or sum(sizes) != capacity:
            raise ValueError(f"bad partition sizes {sizes} for capacity "
                             f"{capacity}")
        starts, acc = [], 0
        for s in sizes:
            starts.append(acc)
            acc += s
        thresholds = tuple(
            NO_OVERRIDE if t.threshold is None else float(t.threshold)
            for t in self.tenants)
        band_lo = tuple(
            NO_OVERRIDE if t.band_lo is None else float(t.band_lo)
            for t in self.tenants)
        return PartitionMap(names=self.names, starts=tuple(starts),
                            sizes=tuple(sizes), thresholds=thresholds,
                            capacity=capacity, band_lo=band_lo)
