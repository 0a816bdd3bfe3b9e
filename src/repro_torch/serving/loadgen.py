"""Multi-tenant request streams over the QA corpus (PyTorch port of the
multi-tenant part of ``repro.serving.loadgen``; the async drivers wait for
the async-serving slice).

``build_multi_tenant_workload`` interleaves per-tenant request streams with
Zipf-skewed tenant popularity. Every tenant's stream is drawn from its own
``random.Random`` seeded from ``(seed, tenant)`` — stable hashing, not
Python's salted ``hash()`` — so adding or removing a tenant never perturbs
another tenant's request sequence, and the stream equals the JAX package's
for the same arguments.
"""
from __future__ import annotations

import hashlib
import random
from typing import Sequence

from repro_torch.data.qa_dataset import QAPair, build_test_queries
from repro_torch.serving.engine import Request


def tenant_rng(seed: int, tenant: str) -> random.Random:
    """A ``random.Random`` stream owned by ``(seed, tenant)``: a stable
    SHA-256 of both, the same in every run and on every host, whichever
    other tenants exist."""
    digest = hashlib.sha256(f"{seed}\x1f{tenant}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def zipf_weights(n: int, skew: float = 1.0) -> list[float]:
    """Normalized Zipf popularity: weight of rank-i tenant ∝ 1/(i+1)^skew.
    ``skew=0`` is uniform; larger = one tenant dominates."""
    raw = [1.0 / (i + 1) ** skew for i in range(n)]
    total = sum(raw)
    return [w / total for w in raw]


def build_multi_tenant_workload(
        pairs: Sequence[QAPair], n_requests: int, *,
        tenants: Sequence[str], skew: float = 1.0,
        paraphrase_ratio: float = 0.75,
        burst_prob: float = 0.0, burst_size: int = 4,
        seed: int = 1) -> list[Request]:
    """Zipf-skewed multi-tenant request stream.

    Tenant popularity follows ``zipf_weights(len(tenants), skew)`` in the
    order given (first tenant = heaviest). Each tenant draws its own
    paper-mixture stream — paraphrase choices, burst rolls and query
    sequence all come from ``tenant_rng(seed, tenant)`` — and a separate
    interleaving stream picks which tenant emits next. So tenant T's
    request sequence is a pure function of (seed, T, n_requests), and
    duplicate bursts (``burst_size`` copies with probability
    ``burst_prob``) stay within one tenant.
    """
    if not tenants:
        raise ValueError("need at least one tenant")
    weights = zipf_weights(len(tenants), skew)
    pick = random.Random(seed)               # interleaving stream only
    streams = {}
    for t in tenants:
        rng = tenant_rng(seed, t)
        base = build_test_queries(
            list(pairs),
            n_per_category=max(1, n_requests // 4 + burst_size),
            paraphrase_ratio=paraphrase_ratio,
            seed=rng.randrange(2 ** 31))
        streams[t] = {"rng": rng, "base": base, "i": 0, "carry": []}
    out: list[Request] = []
    while len(out) < n_requests:
        (t,) = pick.choices(tenants, weights=weights)
        s = streams[t]
        if not s["carry"]:
            q = s["base"][s["i"] % len(s["base"])]
            s["i"] += 1
            copies = burst_size if (burst_prob > 0.0 and
                                    s["rng"].random() < burst_prob) else 1
            req = Request(query=q.query, category=q.category,
                          source_id=q.source_id,
                          semantic_key=q.semantic_key, tenant=t)
            s["carry"] = [req] * copies
        out.append(s["carry"].pop())
    return out
