"""LLM backends for the miss path (PyTorch port of
``repro.serving.llm_backend``).

``SimulatedLLMBackend`` — the offline stand-in for the OpenAI API the paper
calls on cache misses: returns the corpus's gold answer for known/paraphrased
queries (keyed by the query's semantic source) and a templated answer
otherwise, charging a configurable latency + dollar cost per call. The
model-backed backend arrives with the miss-path slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.data.qa_dataset import QAPair


class BackendError(RuntimeError):
    """A backend ``generate`` call failed for the rows that needed it. The
    JAX engine contains it to those rows; in the port that containment
    arrives with the resilience slice, and until then the batch fails."""


class BackendUnavailable(BackendError):
    """The backend refused or errored the call (5xx / connection reset)."""


class BackendTimeout(BackendError):
    """The call consumed its time budget without producing an answer."""


@dataclasses.dataclass
class BackendResult:
    answers: list[str]
    latency_s: float          # simulated/measured wall time for the batch
    cost_usd: float           # API cost charged


class SimulatedLLMBackend:
    """Gold-answer oracle with an API latency/cost model.

    Latency model: a flat ~0.8 s per call, as in the paper's uncached
    measurements. Cost model: $ per call (flat, conservative).
    """

    def __init__(self, pairs: Sequence[QAPair], *,
                 latency_per_call_s: float = 0.8,
                 cost_per_call_usd: float = 0.002):
        self.by_key = {p.semantic_key: p.answer for p in pairs}
        self.by_question = {p.question: p.answer for p in pairs}
        self.latency_per_call_s = latency_per_call_s
        self.cost_per_call_usd = cost_per_call_usd
        self.calls = 0

    def generate(self, queries: Sequence[str],
                 semantic_keys: Sequence[str] | None = None) -> BackendResult:
        answers = []
        for i, q in enumerate(queries):
            if q in self.by_question:
                answers.append(self.by_question[q])
            elif semantic_keys is not None and semantic_keys[i] in self.by_key:
                answers.append(self.by_key[semantic_keys[i]])
            else:
                answers.append(f"Here is a detailed answer to: {q}")
        self.calls += len(queries)
        return BackendResult(
            answers=answers,
            latency_s=self.latency_per_call_s * len(queries),
            cost_usd=self.cost_per_call_usd * len(queries))
