"""Semantic-cache core: slab types, store, exact and IVF indexes, policies,
the ``SemanticCache`` orchestrator and its sharded form
``DistributedCache``, and the paper's HNSW index on the host (PyTorch
port of ``repro.core``)."""
from repro_torch.core.cache import SemanticCache
from repro_torch.core.distributed import (DistributedCache, ShardMesh,
                                          make_mesh, shard_axes)
from repro_torch.core.hnsw import HNSWIndex
from repro_torch.core.index import ExactIndex, ExactState, IVFIndex, IVFState
from repro_torch.core.policy import (AdaptiveThreshold, FixedThreshold,
                                     PerCategoryThreshold, make_policy)
from repro_torch.core.runtime import CacheRuntime, Index, Policy
from repro_torch.core.types import (CacheConfig, CacheState, CacheStats,
                                    LookupResult, init_cache_state,
                                    resolve_device)

__all__ = [
    "CacheConfig", "CacheState", "CacheStats", "LookupResult",
    "init_cache_state", "resolve_device", "CacheRuntime", "Index", "Policy",
    "SemanticCache", "DistributedCache", "ShardMesh", "make_mesh",
    "shard_axes", "ExactIndex", "ExactState", "IVFIndex", "IVFState",
    "HNSWIndex",
    "AdaptiveThreshold", "FixedThreshold", "PerCategoryThreshold",
    "make_policy",
]
