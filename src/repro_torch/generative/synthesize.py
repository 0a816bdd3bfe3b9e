"""Answer synthesis from near-hit neighbours (DESIGN.md §17.3), PyTorch
port of ``repro.generative.synthesize`` (host Python, no tensors).

A query landing in the band [τ_lo, τ_hi) has top-k neighbours that are
*similar but not identical*. Instead of discarding them (the paper's
binary miss), a ``Synthesizer`` composes an answer from their cached
responses at a fraction of full-call cost — the Generative Caching move
(arxiv 2503.17603). Two strategies:

  * ``TemplateSplice`` — pure host-side composition: serve the dominant
    neighbour's cached answer, but only when no *rival* neighbour with a
    different provenance scores within ``rival_margin`` of it. The rival
    gate is the precision mechanism: an ambiguous neighbourhood (two
    unrelated cached questions equally close) abstains back to the full
    backend call rather than guessing. Zero marginal cost and latency.

  * ``SmallModelRewrite`` — the same neighbour selection, then a rewrite
    call through the existing ``llm_backend`` abstraction (anything with
    ``generate(queries, semantic_keys) -> BackendResult``) so a small,
    cheap model adapts the cached answer to the new query's phrasing.
    Cost and latency are whatever the small backend charges — the point
    is that they are a *fraction* of the full model's.

Both are **host-side serving policy**, like the judge: the compiled step
only surfaces the band mask and the top-k payload (ids, scores, cached
responses); which answer to synthesize — or whether to abstain — never
touches device code, so strategy changes never recompile anything.

A synthesis carries the dominant neighbour's ``source_id`` as provenance:
the judge scores a near-hit against that id exactly like an exact hit,
and when the synthesized answer is admitted back into the slab (§17.4)
the entry records where its answer actually came from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, Sequence, runtime_checkable


@dataclasses.dataclass(frozen=True)
class Neighbour:
    """One visible top-k neighbour of a near-hit query."""

    slot: int        # slab slot id
    score: float     # cosine similarity to the (possibly fused) query key
    source_id: int   # provenance of the cached entry (-1 unknown)
    answer: str      # detokenized cached response


@dataclasses.dataclass(frozen=True)
class Synthesis:
    """A composed answer + its provenance and marginal cost."""

    answer: str
    source_id: int      # dominant neighbour's provenance (judge input)
    cost_usd: float = 0.0
    latency_s: float = 0.0


@runtime_checkable
class Synthesizer(Protocol):
    """Strategy seam: neighbours -> answer, or ``None`` to abstain
    (the row then falls back to the full backend call)."""

    def synthesize(self, query: str, neighbours: Sequence[Neighbour]
                   ) -> Synthesis | None:
        ...


@dataclasses.dataclass(frozen=True)
class TemplateSplice:
    """Compose from the dominant neighbour, abstain on ambiguity.

    ``rival_margin`` is the precision knob: serve only when every
    different-provenance neighbour trails the dominant one by at least
    this much cosine. Calibrated on the hash-embedder workload
    (DESIGN.md §17.3): margin 0.12 at τ_lo=0.70 holds ~0.99 judged
    precision while converting ~half the band. Entries with unknown
    provenance (source_id < 0) always count as rivals of each other —
    abstaining on unknowns is what keeps the gate conservative.
    """

    rival_margin: float = 0.12

    def synthesize(self, query: str, neighbours: Sequence[Neighbour]
                   ) -> Synthesis | None:
        if not neighbours:
            return None
        top = max(neighbours, key=lambda nb: nb.score)
        for nb in neighbours:
            if nb is top:
                continue
            same = nb.source_id == top.source_id and top.source_id >= 0
            if not same and top.score - nb.score < self.rival_margin:
                return None                       # ambiguous neighbourhood
        return Synthesis(answer=top.answer, source_id=top.source_id)


#: Prompt scheme shared by SmallModelRewrite and SmallRewriteBackend — the
#: cached answer rides inside the prompt, separated by a sentinel, exactly
#: like a production rewrite prompt carries its context block.
_REWRITE_SEP = "\n---cached---\n"


def rewrite_prompt(query: str, cached_answer: str) -> str:
    return f"adapt the cached answer to: {query}{_REWRITE_SEP}{cached_answer}"


class SmallRewriteBackend:
    """Simulated small rewrite model behind the ``llm_backend`` interface.

    The offline stand-in for a distilled/small hosted model: it extracts
    the cached answer from the rewrite prompt and returns it (an ideal
    rewrite changes phrasing, not meaning — and our judge scores meaning
    via provenance, not bytes), charging a configurable latency and cost
    that default to ~10% of ``SimulatedLLMBackend``'s full-call numbers.
    """

    def __init__(self, *, latency_per_call_s: float = 0.08,
                 cost_per_call_usd: float = 0.0002):
        self.latency_per_call_s = latency_per_call_s
        self.cost_per_call_usd = cost_per_call_usd
        self.calls = 0

    def generate(self, queries: Sequence[str],
                 semantic_keys: Sequence[str] | None = None):
        # imported here: the serving package imports this module
        from repro_torch.serving.llm_backend import BackendResult
        answers = []
        for q in queries:
            _, sep, cached = q.partition(_REWRITE_SEP)
            answers.append(cached if sep else q)
        self.calls += len(queries)
        return BackendResult(
            answers=answers,
            latency_s=self.latency_per_call_s * len(queries),
            cost_usd=self.cost_per_call_usd * len(queries))


@dataclasses.dataclass(frozen=True)
class SmallModelRewrite:
    """Neighbour selection via ``TemplateSplice`` gating, answer via a
    small-model rewrite call. ``backend`` is any ``llm_backend``-shaped
    object; ``None`` constructs the simulated ``SmallRewriteBackend``."""

    backend: Any = None
    splice: TemplateSplice = TemplateSplice()

    def __post_init__(self):
        if self.backend is None:
            object.__setattr__(self, "backend", SmallRewriteBackend())

    def synthesize(self, query: str, neighbours: Sequence[Neighbour]
                   ) -> Synthesis | None:
        base = self.splice.synthesize(query, neighbours)
        if base is None:
            return None
        res = self.backend.generate([rewrite_prompt(query, base.answer)],
                                    [""])
        return Synthesis(answer=res.answers[0], source_id=base.source_id,
                         cost_usd=res.cost_usd, latency_s=res.latency_s)
