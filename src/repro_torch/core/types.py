"""Core datatypes for the semantic cache (PyTorch port of
``repro.core.types``).

The cache is a fixed-capacity slab of embedding keys, response values and
per-entry metadata (TTL deadline, validity, LRU/LFU counters). Each type is
a plain dataclass of tensors that live on one explicit device; the leaf
names and dtypes are those of the JAX package, so checkpoints written by
either package load into the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on. ``None`` means ``"cuda"``.

    There is no silent CPU path: asking for CUDA on a machine without it
    raises, and the caller must pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Static configuration of a semantic cache instance.

    Attributes:
      dim: embedding dimensionality (384 for MiniLM-class, 1536 for ada-002).
      capacity: number of slab slots (paper: Redis keyspace size).
      value_len: stored response length in tokens (fixed-width slab).
      ttl: time-to-live in seconds (paper §2.7). ``None`` disables expiry.
      threshold: cosine-similarity hit threshold (paper: 0.8).
      topk: neighbours retrieved per query (paper: top-k ANN search).
      eviction: slot-selection policy on insert: "ring" | "lru" | "lfu".
      key_dtype: torch dtype of stored keys: float32 (faithful), bfloat16,
        or int8 (the uniform round(normalized * 127) slab quantization).
    """

    dim: int = 384
    capacity: int = 8192
    value_len: int = 32
    ttl: float | None = 3600.0
    threshold: float = 0.8
    topk: int = 4
    eviction: str = "ring"
    key_dtype: Any = torch.float32

    def __post_init__(self):
        if self.eviction not in ("ring", "lru", "lfu"):
            raise ValueError(f"unknown eviction policy {self.eviction!r}")
        if self.capacity <= 0 or self.dim <= 0 or self.value_len <= 0:
            raise ValueError("capacity, dim and value_len must be positive")
        if not (0.0 <= self.threshold <= 1.0):
            raise ValueError("threshold must be within [0, 1]")
        if self.key_dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(f"unsupported key dtype {self.key_dtype!r}")


@dataclasses.dataclass
class CacheState:
    """The slab. All leaves have leading dim = capacity (except scalars)."""

    keys: torch.Tensor        # (N, dim) normalized embeddings
    values: torch.Tensor      # (N, value_len) int32 response token ids
    value_lens: torch.Tensor  # (N,) int32 true response lengths
    expiry: torch.Tensor      # (N,) float32 absolute deadline (inf = never)
    valid: torch.Tensor       # (N,) bool slot occupied & alive
    freq: torch.Tensor        # (N,) int32 hit count since insert (LFU)
    last_used: torch.Tensor   # (N,) float32 last access time (LRU)
    inserted_at: torch.Tensor  # (N,) float32 insert time
    source_id: torch.Tensor   # (N,) int32 provenance id (-1 unknown)
    ptr: torch.Tensor         # () int32 ring insert pointer
    n_inserts: torch.Tensor   # () int32 total inserts (monotone clock)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def dim(self) -> int:
        return self.keys.shape[1]


def init_cache_state(config: CacheConfig, device: torch.device) -> CacheState:
    """Fresh, empty slab on ``device``."""
    n, d, v = config.capacity, config.dim, config.value_len
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return CacheState(
        keys=torch.zeros((n, d), dtype=config.key_dtype, device=device),
        values=torch.zeros((n, v), **i32),
        value_lens=torch.zeros((n,), **i32),
        expiry=torch.full((n,), float("inf"), **f32),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
        freq=torch.zeros((n,), **i32),
        last_used=torch.zeros((n,), **f32),
        inserted_at=torch.zeros((n,), **f32),
        source_id=torch.full((n,), -1, **i32),
        ptr=torch.zeros((), **i32),
        n_inserts=torch.zeros((), **i32),
    )


@dataclasses.dataclass
class LookupResult:
    """Result of a batched cache lookup."""

    index: torch.Tensor       # (B,) int32 best slot
    score: torch.Tensor       # (B,) float32 best cosine (-inf if none visible)
    hit: torch.Tensor         # (B,) bool score >= threshold
    values: torch.Tensor      # (B, value_len) int32 cached response
    value_lens: torch.Tensor  # (B,) int32
    source_id: torch.Tensor   # (B,) int32 provenance of the matched entry
    topk_index: torch.Tensor  # (B, k) int32
    topk_score: torch.Tensor  # (B, k) float32
    near: torch.Tensor        # (B,) bool near-hit band [τ_lo, τ_hi) — all
                              # False on a band-less policy


@dataclasses.dataclass
class CacheStats:
    """Running int32 counters (the paper's Table-1 numbers derive from
    these)."""

    lookups: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    expired_evictions: torch.Tensor
    inserts: torch.Tensor

    def record_lookups(self, n, n_hit: torch.Tensor) -> "CacheStats":
        """Counters after a batch of ``n`` lookups with ``n_hit`` hits."""
        return CacheStats(
            lookups=self.lookups + n,
            hits=self.hits + n_hit,
            misses=self.misses + (n - n_hit),
            expired_evictions=self.expired_evictions,
            inserts=self.inserts,
        )

    def host(self) -> dict[str, int]:
        """The five counters as Python ints, read in one device-to-host
        copy: each copy waits for the device."""
        names = ("lookups", "hits", "misses", "inserts", "expired_evictions")
        vals = torch.stack([getattr(self, n) for n in names]).cpu().tolist()
        return dict(zip(names, vals))

    @staticmethod
    def zeros(device: torch.device) -> "CacheStats":
        def z():
            return torch.zeros((), dtype=torch.int32, device=device)
        return CacheStats(lookups=z(), hits=z(), misses=z(),
                          expired_evictions=z(), inserts=z())

    def hit_rate(self) -> torch.Tensor:
        """hits / lookups as a () f32 tensor, 0 before any lookup."""
        return torch.where(self.lookups > 0,
                           self.hits / torch.clamp(self.lookups, min=1), 0.0)
