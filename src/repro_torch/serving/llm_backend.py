"""LLM backends for the miss path (PyTorch port of
``repro.serving.llm_backend``).

``SimulatedLLMBackend`` — the offline stand-in for the OpenAI API the paper
calls on cache misses: returns the corpus's gold answer for known/paraphrased
queries (keyed by the query's semantic source) and a templated answer
otherwise, charging a configurable latency + dollar cost per call.

``ModelBackend`` — a real decoder (``repro_torch.models.Model``: the
dense, moe, ssm and hybrid families, any width) behind the same interface:
tokenize, prefill, greedy decode, on the model's device; on CUDA its
attention runs through the hand-written flash-attention (prefill) and
decode-attention kernels.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch.data.qa_dataset import QAPair
from repro_torch.data.tokenizer import HashTokenizer


class BackendError(RuntimeError):
    """A backend ``generate`` call failed for the rows that needed it.

    The serving stack resolves it *per row* (DESIGN.md §20.2): cache-hit
    rows in the same micro-batch are served normally, and only the
    true-miss rows whose call failed see it (``Response.error`` from the
    engine, this exception from the async scheduler)."""


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
                 cost_per_call_usd: float = 0.002,
                 block: bool = False):
        # ``block=True`` sleeps one API round-trip per generate() call (a
        # batch of misses shares one RTT, like a batched API call), so the
        # async scheduler's measured latencies are real wall time and a
        # miss leader stays in flight long enough for duplicates to attach
        self.by_key = {p.semantic_key: p.answer for p in pairs}
        self.by_question = {p.question: p.answer for p in pairs}
        self.latency_per_call_s = latency_per_call_s
        self.cost_per_call_usd = cost_per_call_usd
        self.block = block
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
        if self.block:
            time.sleep(self.latency_per_call_s)
        return BackendResult(
            answers=answers,
            latency_s=self.latency_per_call_s * len(queries),
            cost_usd=self.cost_per_call_usd * len(queries))


class ModelBackend:
    """Greedy decoding with a real (usually reduced) architecture, call for
    call as the JAX package's ``ModelBackend``: the prompts padded to
    ``max_prompt_len`` (PAD tokens stay part of the prompt), one prefill
    that builds the caches (KV caches of ``max_prompt_len + max_new_tokens
    + 8`` slots, a ring where the prefill is longer, as hymba's 128 meta
    tokens make it; SSM states), a second full forward for the first
    token's logits (the JAX backend's double prefill, kept as its cost),
    then ``max_new_tokens - 1`` decode steps. Runs under
    ``torch.inference_mode()`` on the model's device; ``latency_s`` reads
    the clock after the generated tokens reach the host."""

    def __init__(self, model, tokenizer: HashTokenizer, *,
                 max_prompt_len: int = 64, max_new_tokens: int = 24):
        self.model = model
        self.tokenizer = tokenizer
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.calls = 0

    def generate(self, queries: Sequence[str],
                 semantic_keys: Sequence[str] | None = None) -> BackendResult:
        t0 = time.perf_counter()
        toks, _ = self.tokenizer.encode_batch(queries, self.max_prompt_len)
        b = toks.shape[0]
        cache_size = self.max_prompt_len + self.max_new_tokens + 8
        dev = self.model.device
        with torch.inference_mode():
            tokens = torch.as_tensor(toks, dtype=torch.long, device=dev)
            _, caches = self.model(tokens, collect_cache=True,
                                   cache_size=cache_size)
            logits = self.model(tokens)
            nt = torch.argmax(logits[:, -1:], dim=-1)
            out = [nt]
            for _ in range(self.max_new_tokens - 1):
                dl, caches = self.model.decode_step(caches, nt)
                nt = torch.argmax(dl, dim=-1)
                out.append(nt)
            gen = torch.cat(out, dim=1).cpu().numpy()   # waits for the card
        answers = [self.tokenizer.decode(gen[i]) for i in range(b)]
        self.calls += b
        return BackendResult(answers=answers,
                             latency_s=time.perf_counter() - t0,
                             cost_usd=0.0)
