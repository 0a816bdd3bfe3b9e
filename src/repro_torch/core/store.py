"""Slab store: insert / evict / expire (paper §2.3, §2.7), PyTorch port of
``repro.core.store``.

A fixed-capacity, device-resident slab. TTL semantics mirror Redis
``SETEX``/``EXPIRE``: every entry carries an absolute deadline and a slot is
*alive* iff it is valid and its deadline has not passed.

Eviction policies (slot selection when inserting into a full slab):
  ring — paper-faithful FIFO ring buffer (oldest-inserted overwritten first);
  lru  — least-recently-used (Redis ``allkeys-lru``);
  lfu  — least-frequently-used (Redis ``allkeys-lfu``).
Empty or expired slots are always preferred over evicting a live entry.

Where the JAX code builds a new array with ``.at[]``, this port updates the
slab tensors in place (``index_copy_``, ``index_add_``,
``scatter_reduce_``): the returned state shares its tensors with the one
passed in, and a slab is never copied per batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import l2_normalize
from repro_torch.core.types import CacheConfig, CacheState

_BIG = 3.0e38


def as_time(now, device: torch.device) -> torch.Tensor:
    """The clock as a 0-d float32 tensor (the JAX code's ``jnp.float32``)."""
    return torch.as_tensor(now, dtype=torch.float32, device=device)


def alive_mask(state: CacheState, now) -> torch.Tensor:
    """(N,) bool: valid and not past TTL deadline."""
    return state.valid & (state.expiry > as_time(now, state.expiry.device))


def expire(state: CacheState, now) -> tuple[CacheState, torch.Tensor]:
    """Mark expired slots invalid (in place). Returns (state, n_expired)."""
    expired = state.valid & (state.expiry <= as_time(now, state.expiry.device))
    n = expired.sum(dtype=torch.int32)
    state.valid &= ~expired
    return state, n


def _eviction_scores(config: CacheConfig, state: CacheState, now
                     ) -> torch.Tensor:
    """Lower score == evict first. Dead slots get -BIG so they always win."""
    dead = ~alive_mask(state, now)
    if config.eviction == "ring":
        score = state.inserted_at
    elif config.eviction == "lru":
        score = state.last_used
    else:  # lfu
        score = state.freq.to(torch.float32)
    return torch.where(dead, torch.full_like(score, -_BIG), score)


def select_slots(config: CacheConfig, state: CacheState, now, m: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pick ``m`` distinct slots to (over)write, per the eviction policy.

    For the ring, masked batches pack the *written* rows contiguously from
    ``ptr`` (masked-out rows are parked on the distinct slots just past the
    written block, where their keep-old write is a no-op), so ``ptr``
    advancing by ``sum(mask)`` leaves no holes in the slab. lru/lfu take the
    ``m`` smallest eviction scores, ties to the lowest slot (stable sort).
    """
    dev = state.ptr.device
    if config.eviction == "ring":
        if mask is None:
            off = torch.arange(m, dtype=torch.int32, device=dev)
        else:
            mi = mask.to(torch.int32)
            written_rank = torch.cumsum(mi, 0, dtype=torch.int32) - mi
            skipped_rank = torch.cumsum(1 - mi, 0, dtype=torch.int32) - (1 - mi)
            off = torch.where(mask, written_rank,
                              mi.sum(dtype=torch.int32) + skipped_rank)
        return ((state.ptr + off) % config.capacity).to(torch.int32)
    scores = _eviction_scores(config, state, now)
    idx = torch.sort(scores, stable=True).indices[:m]
    return idx.to(torch.int32)


def select_slots_tenant(partition, tenant_ptr: torch.Tensor,
                        tenant_id: torch.Tensor, mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tenant ring slot selection inside disjoint slab regions.

    Each tenant runs its own FIFO ring over its contiguous region
    ``[start_t, start_t + size_t)``; ``tenant_ptr`` is the (T,) vector of
    per-tenant ring offsets. Written rows of a tenant pack contiguously from
    that tenant's pointer (the packing of ``select_slots``); masked-out rows
    park on the tenant's slots just past its written block. Slots are
    distinct across tenants by construction, and within a tenant as long as
    a batch's rows of that tenant fit in its region (the engine checks
    ``min region >= batch``).

    Returns ``(slots (B,) int32, new_tenant_ptr (T,) int32)``.
    """
    dev = tenant_ptr.device
    b = tenant_id.shape[0]
    tid = tenant_id.to(torch.int64)
    starts = partition.starts_array(dev)[tid]
    sizes = partition.sizes_array(dev)[tid]
    mask = mask.to(torch.bool)
    same = tenant_id[:, None] == tenant_id[None, :]               # (B, B)
    before = torch.tril(torch.ones((b, b), dtype=torch.bool, device=dev),
                        diagonal=-1)
    i32 = dict(dim=1, dtype=torch.int32)
    written_rank = (same & before & mask[None, :]).sum(**i32)
    skipped_rank = (same & before & ~mask[None, :]).sum(**i32)
    written_total = (same & mask[None, :]).sum(**i32)
    off = torch.where(mask, written_rank, written_total + skipped_rank)
    slots = starts + (tenant_ptr[tid] + off) % sizes
    counts = torch.zeros_like(tenant_ptr).index_add_(
        0, tid, mask.to(torch.int32))
    new_ptr = (tenant_ptr + counts) % partition.sizes_array(dev)
    return slots.to(torch.int32), new_ptr


def insert(config: CacheConfig, state: CacheState, embeddings: torch.Tensor,
           values: torch.Tensor, value_lens: torch.Tensor, now, *,
           source_id: torch.Tensor | None = None,
           mask: torch.Tensor | None = None,
           slots: torch.Tensor | None = None
           ) -> tuple[CacheState, torch.Tensor]:
    """Insert a batch of (embedding, response) pairs (paper §2.5 step 3).

    Rows with ``mask=False`` write their slot's old contents back, so the
    op keeps one shape per batch size and modifies no live slot for them.
    ``slots`` overrides the eviction policy's choice with externally chosen
    distinct slots (``state.ptr`` is then left untouched).

    Returns ``(state, slots)``: the (B,) int32 slot each row was (or, for
    masked rows, would have been) written to.
    """
    dev = state.keys.device
    b = embeddings.shape[0]
    now = as_time(now, dev)
    if source_id is None:
        source_id = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if mask is None:
        mask = torch.ones((b,), dtype=torch.bool, device=dev)

    keys = l2_normalize(embeddings.to(torch.float32))
    if config.key_dtype == torch.int8:
        # symmetric quantization of unit rows: the uniform scale 1/127
        # preserves cosine ranking within ~0.4%. torch.round is
        # half-to-even, as jnp.round is.
        keys = torch.clamp(torch.round(keys * 127.0), -127, 127)
    keys = keys.to(config.key_dtype)
    external_slots = slots is not None
    if not external_slots:
        slots = select_slots(config, state, now, b, mask=mask)
    idx = slots.to(torch.int64)

    def upd(dst: torch.Tensor, src_new: torch.Tensor) -> None:
        sel = mask.reshape((b,) + (1,) * (src_new.dim() - 1))
        dst.index_copy_(0, idx, torch.where(sel, src_new.to(dst.dtype),
                                            dst.index_select(0, idx)))

    f32 = dict(dtype=torch.float32, device=dev)
    expiry = torch.full((b,), float("inf"), **f32)
    if config.ttl is not None:
        expiry = (now + config.ttl).expand(b)
    n_new = mask.sum(dtype=torch.int32)

    upd(state.keys, keys)
    upd(state.values, values)
    upd(state.value_lens, value_lens)
    upd(state.expiry, expiry)
    upd(state.valid, torch.ones((b,), dtype=torch.bool, device=dev))
    upd(state.freq, torch.zeros((b,), dtype=torch.int32, device=dev))
    upd(state.last_used, now.expand(b))
    # strictly increasing within the batch so FIFO order is total
    upd(state.inserted_at, now + torch.arange(b, **f32) * 1e-6)
    upd(state.source_id, source_id)
    if config.eviction == "ring" and not external_slots:
        state.ptr = ((state.ptr + n_new) % config.capacity).to(torch.int32)
    state.n_inserts = state.n_inserts + n_new
    return state, slots


def touch(state: CacheState, slot: torch.Tensor, now, hit: torch.Tensor
          ) -> CacheState:
    """Record an access for LRU/LFU bookkeeping (batched; only where hit).
    Repeated slots add up in ``freq`` and take the max in ``last_used``."""
    now = as_time(now, state.freq.device)
    idx = slot.to(torch.int64)
    state.freq.index_add_(0, idx, hit.to(torch.int32))
    state.last_used.scatter_reduce_(
        0, idx, torch.where(hit, now, torch.full_like(now, float("-inf"))),
        "amax", include_self=True)
    return state


def occupancy(state: CacheState, now) -> float:
    """Fraction of slots alive."""
    return float(alive_mask(state, now).to(torch.float32).mean())
