"""Hit-threshold policies (paper §2.6, §5.3; adaptive = paper §2.10 future
work), PyTorch port of ``repro.core.policy``.

  * fixed — the paper's cosine threshold of 0.8;
  * per-category thresholds — a threshold per query category;
  * adaptive — a control loop that nudges the threshold toward a target
    precision from judged hit outcomes:
    threshold <- threshold + lr * (target - precision).

All policies are functional, ``decide(scores, state) -> (hit_mask, state)``,
and conform to ``repro_torch.core.runtime.Policy``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FixedThreshold:
    """Paper-faithful: hit iff cosine >= threshold (default 0.8)."""

    threshold: float = 0.8

    def init_state(self, device: torch.device) -> torch.Tensor:
        return torch.tensor(self.threshold, dtype=torch.float32, device=device)

    def decide(self, scores: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        return scores >= state, state

    def update(self, state: torch.Tensor, *, was_positive: torch.Tensor,
               was_hit: torch.Tensor) -> torch.Tensor:
        return state  # static


@dataclasses.dataclass(frozen=True)
class PerCategoryThreshold:
    """Category-indexed thresholds; categories supplied per query."""

    thresholds: tuple[float, ...]

    def init_state(self, device: torch.device) -> torch.Tensor:
        return torch.tensor(self.thresholds, dtype=torch.float32, device=device)

    def decide(self, scores: torch.Tensor, state: torch.Tensor,
               category: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        if category is None:
            raise ValueError(
                "PerCategoryThreshold needs per-query categories; the "
                "uniform SemanticCache path does not thread them — call "
                "decide(scores, state, category) directly, or use "
                "FixedThreshold/AdaptiveThreshold with SemanticCache")
        return scores >= state[category.to(torch.int64)], state

    def update(self, state: torch.Tensor, *, was_positive: torch.Tensor,
               was_hit: torch.Tensor) -> torch.Tensor:
        return state  # static


@dataclasses.dataclass(frozen=True)
class AdaptiveThreshold:
    """Precision-tracking controller (beyond-paper; paper §2.10 names it).

    State is (threshold, ema_precision). Each judged batch updates an EMA of
    precision and steps the threshold toward the precision target, inside
    the paper's swept range [0.6, 0.95].
    """

    init: float = 0.8
    target_precision: float = 0.97
    lr: float = 0.02
    ema: float = 0.9
    lo: float = 0.6
    hi: float = 0.95

    def init_state(self, device: torch.device) -> torch.Tensor:
        return torch.tensor([self.init, self.target_precision],
                            dtype=torch.float32, device=device)

    def decide(self, scores: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        return scores >= state[0], state

    def update(self, state: torch.Tensor, *, was_positive: torch.Tensor,
               was_hit: torch.Tensor) -> torch.Tensor:
        """Feed back judged outcomes for a batch. Shapes: (B,) bool each."""
        thr, prec = state[0], state[1]
        n_hit = was_hit.to(torch.float32).sum()
        batch_prec = torch.where(
            n_hit > 0,
            (was_positive & was_hit).to(torch.float32).sum()
            / torch.clamp(n_hit, min=1.0),
            prec)  # no hits -> no evidence
        prec = self.ema * prec + (1.0 - self.ema) * batch_prec
        step = self.lr * (self.target_precision - prec)
        thr = torch.clamp(thr + step, self.lo, self.hi)
        return torch.stack([thr, prec])


def make_policy(kind: str, **kw):
    if kind == "fixed":
        return FixedThreshold(**kw)
    if kind == "per_category":
        return PerCategoryThreshold(**kw)
    if kind == "adaptive":
        return AdaptiveThreshold(**kw)
    raise ValueError(f"unknown policy {kind!r}")
