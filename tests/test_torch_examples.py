"""The port's examples against the reference's: each script of
``examples/`` runs here on the CPU (in this process through ``runpy``, its
stdout captured; the distributed demo in a child process with eight forced
host devices, as it asks), and its twin in ``examples_torch/`` runs with
``--device cpu``. The numbers the twin's ``main`` returns are held to the
reference's, read from the script's globals, from its stdout, or from
recorders on the calls it makes: hit/miss decisions, answers and counts
exactly, scores within 1e-5, counters and the ``train_small`` loss curve
within 1e-4. Numbers that depend on arrival timing in the async scenes
(which rows share a batch or coalesce) are not compared; the invariants
that hold whatever the timing are, on both sides.

Where a model runs (``serve_cached_chatbot``, ``train_small``), each
package draws its own weights from key 0 (``repro_torch.prng`` reproduces
the reference's ``jax.random`` streams). Every example runs in both
threefry modes, set alike in both packages (``threefry_mode``); the
distributed demo's child process gets the mode through
``JAX_THREEFRY_PARTITIONABLE``."""
import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.core.cache import SemanticCache as JSemanticCache
from repro.serving.engine import CachedEngine as JEngine
from repro.serving.scheduler import AsyncScheduler as JScheduler
from repro_torch import prng

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples"
PORT = ROOT / "examples_torch"
NAMES = ("quickstart", "serve_cached_chatbot", "multi_tenant_chatbot",
         "async_chatbot", "multi_turn_chatbot", "generative_cache_chatbot",
         "observability_demo", "resilience_demo", "distributed_cache_demo",
         "train_small")
TOL = {"decisions": 0.0, "scores": 1e-5, "counters": 1e-4}
TRAIN_STEPS = 12          # the reference logs steps 0, 10 and 11
FORBIDDEN = ("jax", "jaxlib", "repro")
# the exposition families observability_demo prints
OBSERVED_FAMILIES = ("repro_queries_total", "repro_coalesced_requests_total",
                     "repro_tenant_hits_total", "repro_latency_quantile",
                     "repro_trace_stage_seconds")


def load_port_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", PORT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same(got, want, tol: float, where: str) -> None:
    """``got`` equals ``want`` leaf by leaf: numbers (not flags) within
    ``tol``, infinities equal, everything else exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(map(str, got)) == \
            sorted(map(str, want)), f"{where}: keys {got} vs {want}"
        for k in want:
            same(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            f"{where}: {got} vs {want}"
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, (int, float)) and not isinstance(want, bool) \
            and tol > 0:
        assert not isinstance(got, bool) and (got == want or abs(
            got - want) <= tol), f"{where}: {got} vs {want} (tol {tol})"
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


class Recorder:
    """Records what the reference's examples compute inside functions and
    coroutines: every ``SemanticCache.lookup`` result, every
    ``CachedEngine.process`` call's responses and every request the async
    scheduler answered."""

    def __init__(self, monkeypatch):
        self.lookups, self.processed, self.submitted = [], [], []
        lookup, process, submit = (JSemanticCache.lookup, JEngine.process,
                                   JScheduler.submit)

        def rec_lookup(cache, *a, **kw):
            out = lookup(cache, *a, **kw)
            self.lookups.append(out[0])
            return out

        def rec_process(engine, requests):
            out = process(engine, requests)
            self.processed.append(out)
            return out

        async def rec_submit(sched, request):
            out = await submit(sched, request)
            self.submitted.append((request, out))
            return out

        monkeypatch.setattr(JSemanticCache, "lookup", rec_lookup)
        monkeypatch.setattr(JEngine, "process", rec_process)
        monkeypatch.setattr(JScheduler, "submit", rec_submit)


def run_reference(name: str, monkeypatch, *argv) -> tuple[dict, str]:
    """The JAX example as ``python examples/<name>.py``: its globals and
    its stdout."""
    monkeypatch.setattr(sys, "argv", [str(REFERENCE / f"{name}.py"), *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(str(REFERENCE / f"{name}.py"),
                           run_name="__main__")
    return g, buf.getvalue()


def run_port(name: str, capsys, *argv) -> dict:
    out = load_port_example(name).main(["--device", "cpu", *argv])
    capsys.readouterr()
    return out


@pytest.fixture(autouse=True, params=[True, False],
                ids=["partitionable", "original"])
def threefry_mode(request):
    """Both threefry modes, set alike in jax and in ``repro_torch.prng``:
    partitionable (jax >= 0.5's default) and original (jax 0.4's)."""
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    with prng.partitionable(request.param):
        yield request.param
    jax.config.update("jax_threefry_partitionable", was)


def flag(text: str, pattern: str) -> str:
    m = re.search(pattern, text)
    assert m, f"no {pattern!r} in the reference's output"
    return m.group(1)


# -- one reader a reference example ------------------------------------- #
def ref_quickstart(g, text, rec, **_):
    first, other = rec.lookups
    tok = g["tok"]
    stats = g["runtime"].stats
    return {"decisions": {"hit": bool(first.hit[0]),
                          "answer": tok.decode(np.asarray(first.values[0])),
                          "unrelated_hit": bool(other.hit[0])},
            "scores": {"cosine": float(first.score[0]),
                       "unrelated": float(other.score[0])},
            "counters": {"lookups": int(stats.lookups),
                         "hits": int(stats.hits)}}


def ref_serve_cached_chatbot(g, text, rec, **_):
    r1, r2 = g["r1"], g["r2"]
    summary = g["engine"].metrics.summary()
    return {"decisions": {"pass1_cached": [r.cached for r in r1],
                          "pass2_cached": [r.cached for r in r2],
                          "pass1_answers": [r.answer for r in r1],
                          "pass2_answers": [r.answer for r in r2],
                          "model_calls": g["calls_before"],
                          "new_model_calls":
                          g["backend"].calls - g["calls_before"]},
            "scores": {"pass1": [r.score for r in r1],
                       "pass2": [r.score for r in r2]},
            "counters": {"categories": summary["categories"],
                         "queries": summary["queries"]}}


def ref_multi_tenant_chatbot(g, text, rec, **_):
    # recorded as they completed; the script gathers them in request order
    order = {p.question: i for i, p in enumerate(g["pairs"][:20])}
    vip = [resp for req, resp in sorted(
        (x for x in rec.submitted if x[0].tenant == "acme"),
        key=lambda x: order[x[0].query])]
    flood = [resp for req, resp in rec.submitted if req.tenant == "free"]
    stats = g["engine"].tenant_stats()
    host = g["engine"].metrics.summary()["tenants"]
    first, again, cross = g["first"], g["again"], g["cross"]
    return {"decisions": {"isolation": [first.cached, again.cached,
                                        cross.cached],
                          "vip_cached": [r.cached for r in vip],
                          "vip_answers": [r.answer for r in vip],
                          "flood_answered": sum(bool(r.answer)
                                                for r in flood)},
            "scores": {"isolation": [first.score, again.score, cross.score],
                       "vip": [r.score for r in vip]},
            "counters": {
                "acme": stats["acme"], "globex": stats["globex"],
                **{f"{t}_host": {k: host[t][k]
                                 for k in ("lookups", "cache_hits")}
                   for t in ("acme", "globex")}}}


def ref_async_chatbot(g, text, rec, **_):
    herd = [resp for req, resp in rec.submitted
            if req.query == "do you ship the limited edition console to "
                            "antarctica"]
    traffic = rec.submitted[len(herd):]
    return {"decisions": {
                "herd_answer": herd[0].answer,
                "herd_backend_calls": int(flag(text, r"-> (\d+) backend")),
                "herd_coalesced": sum(r.coalesced for r in herd),
                "traffic_answered": sum(bool(r.answer)
                                        for _, r in traffic)},
            "scores": {}, "counters": {}}


def ref_multi_turn_chatbot(g, text, rec, **_):
    rows = [g[k] for k in ("rec_open", "rec_follow", "rep_open",
                           "rep_follow", "flat", "other")]
    replies = g["replies"]
    return {"decisions": {
                "cached": [r.cached for r in rows],
                "answers": [r.answer for r in rows],
                "wire": {i: {k: replies[i].get(k)
                             for k in ("answer", "cached", "context")}
                         for i in sorted(replies)},
                "wire_keys": {i: sorted(replies[i]) for i in sorted(replies)},
                "sessions": g["fused"].sessions.stats()},
            "scores": {"turns": [r.score for r in rows],
                       "wire": [replies[i]["score"] for i in sorted(replies)]},
            "counters": {}}


def ref_generative_cache_chatbot(g, text, rec, **_):
    exact_resp, band_resp, again = g["exact_resp"], g["band_resp"], g["again"]
    near, m = g["near"], g["m"]

    def flags(resp):
        return [(r.cached, r.near_hit) for r in resp]
    return {"decisions": {
                "exact": flags(exact_resp), "banded": flags(band_resp),
                "banded_answers": [r.answer for r in band_resp],
                "exact_answers": [r.answer for r in exact_resp],
                "backend_calls": [g["banded"].backend.calls,
                                  g["exact"].backend.calls],
                "admission": [g["i"], again.cached, again.near_hit,
                              again.answer],
                "abstention": [g["confident"].answer, g["rivalrous"]],
                "rewrite_calls": [m.served, g["small"].calls],
                "wire": [g["with_band"]["cached"], g["with_band"]["near_hit"],
                         sorted(g["without"])]},
            "scores": {"banded": [r.score for r in band_resp],
                       "exact": [r.score for r in exact_resp]},
            "counters": {"band": near.band, "served": near.served,
                         "precision": near.precision,
                         "synthesis_cost_usd": m.synthesis_cost_usd}}


def ref_observability_demo(g, text, rec, **_):
    engine = g["engine"]
    # explain is a dry run: asked again it gives the record the script
    # printed
    why = engine.explain(g["pairs"][0].question, tenant="acme")
    families = sorted({w for w in OBSERVED_FAMILIES
                       for line in text.splitlines() if line.startswith(w)})
    return {"decisions": {
                "answered": sum(bool(r.answer) for _, r in rec.submitted),
                "explain": {k: why[k] for k in (
                    "decision", "matched_source_id", "threshold_source",
                    "band", "in_band", "session_fused", "tenant",
                    "dry_run")},
                "families": families,
                "stages": sorted(engine.tracer.stage_decomposition())},
            "scores": {"explain": [why["score"], why["effective_threshold"]]},
            "counters": {}}


def ref_resilience_demo(g, text, rec, **_):
    rows = [out[0] for out in rec.processed]
    breaker = g["resilience"].breaker
    return {"decisions": {
                "cached": [r.cached for r in rows],
                "degraded": [r.degraded for r in rows],
                "answers": [r.answer for r in rows],
                "errors": [r.error for r in rows],
                "breaker": [[flag(text, r"outage: .*breaker=(\w+)"),
                             int(flag(text, r"trips=(\d+)"))],
                            [flag(text, r"recovery: .*breaker=(\w+)"),
                             int(flag(text, r"recoveries=(\d+)"))],
                            breaker.state],
                "deadline_calls_spent":
                int(flag(text, r"backend_calls_spent=(\d+)")),
                "faults_injected": g["backend"].faults_injected},
            "scores": {"rows": [r.score for r in rows]},
            "counters": {"resilience": g["summary"]["resilience"]}}


DISTRIBUTED = r"""
import json, runpy, sys
import numpy as np
g = runpy.run_path(sys.argv[1], run_name="__main__")
tok = g["tok"]       # its decoder table holds the words the script encoded
slot, v, vl = (np.asarray(g[k]) for k in ("slot", "v", "vl"))
stats = g["runtime"].stats
print("RESULT " + json.dumps({
    "hits": np.asarray(g["hit"]).tolist(),
    "shards": (slot // g["dc"].local_capacity).tolist(),
    "answers": [tok.decode(row[:n]) for row, n in zip(v, vl.tolist())],
    "scores": np.asarray(g["score"]).tolist(),
    "entries_per_shard": g["per_shard"].tolist(),
    "stats": {k: int(getattr(stats, k)) for k in ("lookups", "hits",
                                                  "inserts")}}))
"""


def ref_distributed_cache_demo(g, text, rec, **_):
    r = json.loads(flag(text, r"RESULT (.*)"))
    return {"decisions": {"cold_hits": int(flag(text, r"hits=(\d+)/4")),
                          "hits": r["hits"], "shards": r["shards"],
                          "answers": r["answers"]},
            "scores": {"paraphrases": r["scores"]},
            "counters": {"entries_per_shard": r["entries_per_shard"],
                         "stats": r["stats"]}}


def ref_train_small(g, text, rec, **_):
    logged = {int(s): float(x) for s, x in
              re.findall(r"^step\s+(\d+) loss ([\d.]+)", text, re.M)}
    assert sorted(logged) == [0, 10, TRAIN_STEPS - 1]
    return {"decisions": {"steps": TRAIN_STEPS},
            "scores": {}, "counters": {"logged_losses": logged}}


REFERENCE_READERS = {name: globals()[f"ref_{name}"] for name in NAMES}


def run_pair(name, tmp_path, monkeypatch, capsys):
    """(port's numbers, reference's numbers) of one example."""
    rec = Recorder(monkeypatch)
    argv, port_argv = (), ()
    if name == "distributed_cache_demo":
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "JAX_THREEFRY_PARTITIONABLE": str(int(
                   prng.is_partitionable())),
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "PYTHONPATH": os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
        done = subprocess.run(
            [sys.executable, "-c", DISTRIBUTED,
             str(REFERENCE / f"{name}.py")], env=env, capture_output=True,
            text=True, timeout=600, cwd=str(tmp_path))
        assert done.returncode == 0, done.stderr[-3000:]
        g, text = {}, done.stdout
    else:
        if name == "train_small":
            argv = ("--reduced", "--steps", str(TRAIN_STEPS))
            port_argv = (*argv, "--checkpoint", str(tmp_path / "port.npz"))
            ckpt = str(tmp_path / "reference.npz")
            train_main = jtrain.main

            def redirected_main():
                # the reference writes its checkpoint under /tmp
                sys.argv = [ckpt if a.endswith(".npz") else a
                            for a in sys.argv]
                return train_main()
            monkeypatch.setattr(jtrain, "main", redirected_main)
        g, text = run_reference(name, monkeypatch, *argv)
    want = REFERENCE_READERS[name](g, text, rec)
    got = run_port(name, capsys, *port_argv)
    return got, want, g


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_reference(name, tmp_path, monkeypatch, capsys):
    got, want, g = run_pair(name, tmp_path, monkeypatch, capsys)
    tol = dict(TOL)
    if name == "train_small":
        losses = got["counters"]["losses"]
        assert len(losses) == TRAIN_STEPS and losses[-1] < losses[0]
        got = {**got, "counters": {"logged_losses": {
            s: losses[s] for s in want["counters"]["logged_losses"]}}}
        # the reference prints 4 decimals: half a unit of rounding on top
        tol["counters"] += 5e-5
    for part in TOL:
        same(got[part], want[part], tol[part], f"{name}.{part}")
    if name == "multi_tenant_chatbot":
        # the flood's split into hits, misses and coalesced rows depends on
        # timing; what holds for any split, in both packages
        engine = g["engine"]
        for stats, host in (
                (got["observed"]["free"], got["observed"]["free_host"]),
                (engine.tenant_stats()["free"],
                 engine.metrics.summary()["tenants"]["free"])):
            assert stats["lookups"] == host["lookups"] == \
                stats["hits"] + stats["misses"]
            assert host["lookups"] + host["coalesced_calls"] == 240
            assert stats["inserts"] == 60 + stats["misses"]


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_cuda(name):
    """Every script defaults to CUDA and has no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_port_example(name).main([])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_examples_import_no_jax():
    """One twin a reference example, and none imports jax or a ``repro``
    module."""
    assert sorted(p.stem for p in PORT.glob("*.py")) == \
        sorted(p.stem for p in REFERENCE.glob("*.py")) == sorted(NAMES)
    for path in sorted(PORT.glob("*.py")):
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path.name} imports {bad}"
