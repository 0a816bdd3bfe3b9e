"""Multi-tenant cache namespaces (PyTorch port of ``repro.tenancy``).

One device-resident semantic cache, many isolation domains: the registry
describes tenants (capacity shares, admission weights, optional threshold
overrides), the partition map splits the slab into contiguous per-tenant
regions, and ``TenancyState`` carries per-tenant ring pointers and
accounting inside the ``CacheRuntime``.
"""
from repro_torch.tenancy.partition import PartitionMap, TenancyState
from repro_torch.tenancy.registry import (NO_OVERRIDE, TenantRegistry,
                                          TenantSpec)

__all__ = ["PartitionMap", "TenancyState", "TenantRegistry", "TenantSpec",
           "NO_OVERRIDE"]
