"""Resilient serving on the PyTorch port: a backend outage the cache
survives (DESIGN.md §20).

    PYTHONPATH=src python examples_torch/resilience_demo.py [--device cpu]

Five scenes over the simulated LLM API wrapped in a deterministic fault
schedule (windows are keyed by backend call index, so every run of this
script injects exactly the same faults):

  1. a *transient blip*: one failed call, absorbed by a budgeted retry;
     the caller never notices;
  2. a *hard outage*: every call fails; the circuit breaker trips and
     the warm cache keeps answering in degraded mode (best cached
     neighbour above the relaxed floor, flagged ``degraded=True``, never
     admitted to the slab);
  3. *recovery*: the outage window ends, a half-open probe succeeds,
     the breaker closes, and the same query now pays a real backend call
     (proof the degraded answer was never cached under its key);
  4. a *spent deadline*: ``deadline_ms=0`` skips the backend entirely
     and the row falls straight to degraded serving;
  5. the serving summary's ``resilience`` section plus the breaker's
     final state.
"""
import argparse
import json

from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.qa_dataset import build_corpus
from repro_torch.serving import (CachedEngine, CircuitBreaker, FaultSchedule,
                                 FaultWindow, FaultyBackend, Request,
                                 ResilienceConfig, RetryPolicy,
                                 SimulatedLLMBackend)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    print("warming the semantic cache with the QA corpus ...")
    pairs = build_corpus(150, seed=0)

    # call-index fault schedule: call 0 is a blip, calls 2-6 a hard outage
    schedule = FaultSchedule((
        FaultWindow("error", 0, 1),      # scene 1: one transient failure
        FaultWindow("error", 2, 7),      # scene 2: sustained outage
    ))
    backend = FaultyBackend(SimulatedLLMBackend(pairs), schedule)

    resilience = ResilienceConfig(
        retry=RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                          max_backoff_s=0.05),
        breaker=CircuitBreaker(failure_threshold=3, cooldown_s=0.0),
        degraded_band_lo=0.3)            # relaxed floor for the demo corpus
    engine = CachedEngine(
        CacheConfig(dim=384, capacity=8192, value_len=48, ttl=None,
                    threshold=0.8),
        backend, batch_size=4, resilience=resilience, device=device)
    engine.warm(pairs)
    breaker = resilience.breaker

    # -- scene 1: transient blip, absorbed by one retry ------------------ #
    blip = engine.process([Request(query="does the orbital hotel have a "
                                         "gym")])[0]
    rm = engine.metrics.resilience
    print(f"blip: answered={bool(blip.answer)} degraded={blip.degraded} "
          f"retries={rm.retries} retry_successes={rm.retry_successes}")
    assert blip.answer and not blip.degraded and rm.retry_successes == 1

    # -- scene 2: hard outage -> breaker trips, cache serves degraded ---- #
    outage_q = "recommend a warranty plan for my kitchen robot"
    outage = engine.process([Request(query=outage_q)])[0]
    print(f"outage: degraded={outage.degraded} score={outage.score:.2f} "
          f"breaker={breaker.state} trips={breaker.trips} "
          f"answer={outage.answer[:40]!r}...")
    assert outage.degraded and outage.error == ""
    tripped = [breaker.state, breaker.trips]

    # -- scene 3: recovery: probe closes the breaker, query pays for real #
    recovery = engine.process([Request(query=outage_q)])[0]
    print(f"recovery: cached={recovery.cached} degraded={recovery.degraded} "
          f"breaker={breaker.state} recoveries={breaker.recoveries}")
    # the degraded answer was never admitted, so this is a REAL miss + call
    assert not recovery.degraded and breaker.state == "closed"
    recovered = [breaker.state, breaker.recoveries]

    # -- scene 4: a spent deadline fails fast, no backend call ----------- #
    calls = backend.calls_started
    late = engine.process([Request(query="what is the meaning of liff",
                                   deadline_ms=0.0)])[0]
    spent = backend.calls_started - calls
    print(f"deadline: served_degraded={late.degraded} "
          f"backend_calls_spent={spent}")
    assert spent == 0 and late.degraded

    # -- scene 5: the resilience section of the serving summary ---------- #
    summary = engine.metrics.summary()
    print(json.dumps({"resilience": summary["resilience"],
                      "faults_injected": backend.faults_injected,
                      "breaker_state": breaker.state}, indent=1))
    rows = (blip, outage, recovery, late)
    return {"decisions": {"cached": [r.cached for r in rows],
                          "degraded": [r.degraded for r in rows],
                          "answers": [r.answer for r in rows],
                          "errors": [r.error for r in rows],
                          "breaker": [tripped, recovered, breaker.state],
                          "deadline_calls_spent": spent,
                          "faults_injected": backend.faults_injected},
            "scores": {"rows": [r.score for r in rows]},
            "counters": {"resilience": summary["resilience"]},
            "observed": {}}


if __name__ == "__main__":
    main()
