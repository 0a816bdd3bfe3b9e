"""BandPolicy — tiered threshold bands for the generative near-hit cache
(DESIGN.md §17.2), PyTorch port of ``repro.generative.policy``.

The paper's lookup is binary: one cosine threshold τ splits hit from miss,
and a query scoring 0.79 discards its top-k neighbours and pays a full LLM
call. ``BandPolicy`` adds a band below τ where cheap answer synthesis from
the neighbours recovers backend calls (Generative Caching, arxiv
2503.17603):

    score >= τ_hi          — exact reuse (the hit path, unchanged)
    τ_lo <= score < τ_hi   — near-hit: the top-k neighbours go to a
                             host-side ``Synthesizer``
    score < τ_lo           — miss (full backend call)

τ_lo is inclusive and τ_hi exclusive; the cache strips hit rows from the
near mask (``& ~hit``), so a per-tenant τ_hi override moves the band's
upper edge with it.

``decide`` equals ``FixedThreshold(τ_hi)``, so a band cache without a
synthesizer makes exactly the binary decisions. The cache discovers the
two band methods with ``hasattr``:

  * ``near(scores, state)`` — the [τ_lo, τ_hi) membership mask;
  * ``update_band(state, was_positive, was_near)`` — judged near-hit
    outcomes nudge τ_lo as ``AdaptiveThreshold`` nudges its threshold:
    synthesis precision below target raises τ_lo (shrinks the band),
    surplus precision lowers it.

State: a (3,) f32 tensor ``[τ_lo, τ_hi, ema_near_precision]``. Only τ_lo
adapts.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BandPolicy:
    """Two-edge threshold band; the exact path is FixedThreshold(τ_hi)."""

    tau_lo: float = 0.70
    tau_hi: float = 0.80
    # judged near-hit feedback loop (0 lr = static edges)
    target_precision: float = 0.92
    lr: float = 0.02
    ema: float = 0.9
    lo_min: float = 0.55
    min_width: float = 0.01     # τ_lo never crosses τ_hi - min_width
    # degraded-mode floor (DESIGN.md §20.4): the lowest score at which the
    # engine serves a cached neighbour while the backend is down. None ->
    # the engine's default floor. Never above τ_lo: degraded serving
    # relaxes the band's lower edge, never tightens it.
    degraded_lo: float | None = None

    def __post_init__(self):
        if not (0.0 <= self.tau_lo <= self.tau_hi <= 1.0):
            raise ValueError(
                f"need 0 <= tau_lo <= tau_hi <= 1, got "
                f"({self.tau_lo}, {self.tau_hi})")
        if self.lo_min > self.tau_lo:
            raise ValueError("lo_min must not exceed tau_lo")
        if self.degraded_lo is not None:
            if not (0.0 <= self.degraded_lo <= 1.0):
                raise ValueError(
                    f"degraded_lo must lie in [0, 1], got {self.degraded_lo}")
            if self.degraded_lo > self.tau_lo:
                raise ValueError(
                    f"degraded_lo ({self.degraded_lo}) must not exceed "
                    f"tau_lo ({self.tau_lo}) — degraded serving relaxes "
                    "the band edge, never tightens it")

    # -- Policy protocol (uniform with Fixed/AdaptiveThreshold) ----------- #
    def init_state(self, device: torch.device) -> torch.Tensor:
        return torch.tensor([self.tau_lo, self.tau_hi, self.target_precision],
                            dtype=torch.float32, device=device)

    def decide(self, scores: torch.Tensor, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact-reuse decision: hit iff score >= τ_hi."""
        return scores >= state[1], state

    def update(self, state: torch.Tensor, *, was_positive: torch.Tensor,
               was_hit: torch.Tensor) -> torch.Tensor:
        return state  # the exact edge is static; the band edge adapts below

    # -- band seam (found by the cache with hasattr) ---------------------- #
    def near(self, scores: torch.Tensor, state: torch.Tensor
             ) -> torch.Tensor:
        """[τ_lo, τ_hi) membership: τ_lo inclusive, τ_hi exclusive."""
        return (scores >= state[0]) & (scores < state[1])

    def update_band(self, state: torch.Tensor, *, was_positive: torch.Tensor,
                    was_near: torch.Tensor) -> torch.Tensor:
        """Judged synthesized-answer outcomes for a batch -> new τ_lo.

        An EMA of near-hit precision tracks ``target_precision``; τ_lo is
        kept in ``[lo_min, τ_hi - min_width]``, so the band can shrink to
        (almost) nothing but never inverts. The f32 operations run in the
        reference's order, so τ_lo drifts as the reference's does.
        """
        lo, hi, prec = state[0], state[1], state[2]
        n_near = was_near.to(torch.float32).sum()
        batch_prec = torch.where(
            n_near > 0,
            (was_positive & was_near).to(torch.float32).sum()
            / torch.clamp(n_near, min=1.0),
            prec)  # no near-hits -> no evidence
        prec = self.ema * prec + (1.0 - self.ema) * batch_prec
        step = self.lr * (self.target_precision - prec)
        # jnp.clip(x, a, b) = minimum(maximum(x, a), b), b a tensor here
        lo = torch.minimum(torch.clamp(lo + step, min=self.lo_min),
                           hi - self.min_width)
        return torch.stack([lo, hi, prec])
