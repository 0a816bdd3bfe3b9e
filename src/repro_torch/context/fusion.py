"""Context fusion — pooling a session's recent turns into the lookup key
(DESIGN.md §16.2), PyTorch port of ``repro.context.fusion``.

Multi-turn chat traffic breaks a cache keyed on isolated queries: "what
about the second one?" embeds nowhere near the dialogue state it asks
about, and the same follow-up text under two conversations would collide.
Fusing the last ``W`` turn embeddings into the query embedding makes
semantically equivalent *dialogue states* share a key (ContextCache, arxiv
2506.22791). This module is the device half: one pooling op
``(B, W, d) -> (B, d)``, two strategies behind the ``ContextFusion``
protocol:

  * ``DecayMeanFusion`` — exponential-decay mean over the turn window
    (recent turns weigh more), mixed with the query;
  * ``AttentionFusion`` — the query attends over the turn window (scaled
    dot-product softmax), so only the turns it refers back to contribute.

Both carry their scalar weights in a ``FusionState`` of 0-d f32 tensors on
the cache's device, the ``fusion`` leaf group of ``CacheRuntime`` (``None``
on a fusion-less cache).

The pooling sums are written as f32 broadcast multiplies and sums, not
``einsum``: on CUDA an einsum goes to cuBLAS, which may take TF32, and TF32
moves cosine scores by more than the main configuration's closest score
lies from τ.

Contract shared by every strategy: rows with an empty window
(``window_len == 0``) return the query embedding bit-identically, so a
sessionless request through a fusion-enabled cache behaves exactly like the
stateless path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.similarity import l2_normalize as _unit
from repro_torch.core.types import resolve_device


@dataclasses.dataclass
class FusionState:
    """Fusion weights — one more ``CacheRuntime`` leaf group.

    Leaves (0-d f32 tensors):
      context_weight — energy fraction of (rotated) pooled context in the
                       fused key; the query keeps ``1 - cw`` (see ``_mix``);
      decay          — per-turn exponential decay (DecayMeanFusion);
      temp           — attention temperature (AttentionFusion).

    One state class for both strategies keeps the checkpoint layout the
    same: a snapshot taken under decay-mean restores into an attention
    cache (the unused leaf rides along).
    """

    context_weight: torch.Tensor
    decay: torch.Tensor
    temp: torch.Tensor

    @staticmethod
    def make(context_weight: float, decay: float = 0.6, temp: float = 0.25,
             device: str | torch.device = "cuda") -> "FusionState":
        """The weights as 0-d f32 tensors on ``device`` (default CUDA;
        raises without it unless ``device="cpu"``)."""
        device = resolve_device(device)

        def f(x):
            return torch.tensor(x, dtype=torch.float32, device=device)
        return FusionState(context_weight=f(context_weight), decay=f(decay),
                           temp=f(temp))


@runtime_checkable
class ContextFusion(Protocol):
    """Pluggable pooling strategy (the ``Index``/``Policy`` pattern).

    A strategy is a frozen dataclass; its numeric weights live in the
    ``FusionState`` it creates, carried by the runtime.
    """

    window: int   # W — turns pooled per session

    def init_state(self, device) -> FusionState:
        ...

    def fuse(self, fstate: FusionState, queries: torch.Tensor,
             window: torch.Tensor, window_len: torch.Tensor) -> torch.Tensor:
        """(B, d) queries + (B, W, d) turn windows -> (B, d) fused keys.

        ``window`` is left-aligned oldest-to-newest: row ``b``'s turns
        occupy ``window[b, :window_len[b]]``; the tail is zeros. Rows with
        ``window_len == 0`` must return ``queries`` bit-identically.
        """
        ...


def _mix(fstate: FusionState, queries: torch.Tensor, ctx: torch.Tensor,
         window_len: torch.Tensor) -> torch.Tensor:
    """Shared final stage: embed the pooled context in a *rotated* subspace
    and mix with the query at energy split ``context_weight``:

        fused = unit( sqrt(1-cw)·q̂  +  sqrt(cw)·roll(ĉ, d/2) )

    The half-dimension roll decorrelates context from every raw key, so
    the similarity of two fused keys separates as
    ``(1-cw)·cos(q1,q2) + cw·cos(c1,c2)`` and a fused key scores at most
    ``sqrt(1-cw)`` against any raw slab key: a follow-up never false-hits
    a previous turn's entry, and the same follow-up text under two
    dialogue states scores ≈ 1-cw apart.

    Empty-window rows pass through untouched (bit-identical)."""
    cw = fstate.context_weight
    a = torch.sqrt(torch.clamp(1.0 - cw, min=0.0))
    b = torch.sqrt(cw)
    rot = torch.roll(_unit(ctx), shifts=ctx.shape[-1] // 2, dims=-1)
    fused = _unit(a * _unit(queries) + b * rot)
    return torch.where((window_len > 0)[:, None], fused, queries)


def _check(window: int, context_weight: float) -> None:
    if window < 1:
        raise ValueError("fusion window must be >= 1")
    if not 0.0 <= context_weight < 1.0:
        raise ValueError("context_weight must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class DecayMeanFusion:
    """Exponential-decay mean pooling: the turn at age ``a`` (0 = most
    recent) weighs ``decay**a``. Cheap, parameter-light, order-aware."""

    window: int = 4
    context_weight: float = 0.8
    decay: float = 0.6

    def __post_init__(self):
        _check(self.window, self.context_weight)
        if not 0.0 < self.decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")

    def init_state(self, device: str | torch.device = "cuda"
                   ) -> FusionState:
        return FusionState.make(self.context_weight, decay=self.decay,
                                device=device)

    def fuse(self, fstate: FusionState, queries: torch.Tensor,
             window: torch.Tensor, window_len: torch.Tensor) -> torch.Tensor:
        w = window.shape[1]
        wl = window_len.to(torch.int32)[:, None]
        pos = torch.arange(w, dtype=torch.int32, device=window.device)[None]
        valid = pos < wl                                         # (B, W)
        # turn j (left-aligned) has age L-1-j; the clamp keeps pow defined
        # on masked lanes
        age = torch.clamp(wl - 1 - pos, min=0).to(torch.float32)
        wgt = torch.where(valid, torch.pow(fstate.decay, age),
                          torch.zeros((), dtype=torch.float32,
                                      device=window.device))
        ctx = (wgt[:, :, None] * _unit(window)).sum(dim=1)
        return _mix(fstate, queries, ctx, window_len)


@dataclasses.dataclass(frozen=True)
class AttentionFusion:
    """Attention-weighted pooling: the query attends over the turn window
    (scaled dot-product softmax at temperature ``temp``), so a follow-up
    that refers back two turns pulls exactly that turn into the key."""

    window: int = 4
    context_weight: float = 0.8
    temp: float = 0.25

    def __post_init__(self):
        _check(self.window, self.context_weight)
        if self.temp <= 0.0:
            raise ValueError("temp must be positive")

    def init_state(self, device: str | torch.device = "cuda"
                   ) -> FusionState:
        return FusionState.make(self.context_weight, temp=self.temp,
                                device=device)

    def fuse(self, fstate: FusionState, queries: torch.Tensor,
             window: torch.Tensor, window_len: torch.Tensor) -> torch.Tensor:
        w = window.shape[1]
        turns = _unit(window)                                    # (B, W, d)
        valid = torch.arange(w, dtype=torch.int32, device=window.device)[
            None] < window_len.to(torch.int32)[:, None]          # (B, W)
        logits = (_unit(queries)[:, None, :] * turns).sum(dim=-1) \
            / fstate.temp
        logits = torch.where(valid, logits,
                             torch.full_like(logits, -1e9))
        # empty rows: a uniform softmax over -1e9 lanes, harmless: _mix
        # routes those rows straight through
        alpha = torch.softmax(logits, dim=-1)                    # (B, W)
        ctx = (alpha[:, :, None] * turns).sum(dim=1)
        return _mix(fstate, queries, ctx, window_len)


def fuse_op(fusion: Any, fstate: FusionState, queries: torch.Tensor,
            window: torch.Tensor, window_len: torch.Tensor) -> torch.Tensor:
    """The standalone ``(B, W, d) -> (B, d)`` pooling op: the same call
    ``SemanticCache`` makes before its search and insert."""
    return fusion.fuse(fstate, queries, window, window_len)


__all__ = ["ContextFusion", "FusionState", "DecayMeanFusion",
           "AttentionFusion", "fuse_op"]
