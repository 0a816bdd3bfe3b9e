"""One run of a cell: build the port's serving stack, warm it, offer the
cell's traffic open loop, measure, then judge every answer.

The system under test is ``repro_torch.serving.server.AsyncCacheServer``
with its default scheduler (flush at ``max_batch`` = the engine's batch or
after 5 ms, coalescing on, overload policy ``block``) over a
``CachedEngine`` whose misses go to a ``ModelBackend`` over
``repro_torch.models.Model``. The benchmark reaches into it only through
subclasses of its own that record what the program did: which requests
shared a served batch (``RecordingEngine``), the slot each lookup matched
(``_StepRecorder``), the tokens the model generated (``RecordingTokenizer``
sees each row's tokens where the backend reads them back).

Set-up is steps 1-4: load, build the model from weights made on the
device from ``--seed``, warm the cache with the corpus, serve the
traffic's warm-up batches (the largest miss shape first). ``setup_s`` runs
from the start of ``run.py`` to the first due arrival. Then the arrivals
of the lead-in and the window are offered on their due times; each
request's response time runs from its due time to the moment its
submitter resumes with the answer. After the last answer the program is
freed, and the references judge what it served (``judge``).
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import random
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cachebench import (counts, devtrace, metrics as readers, refcache,
                        refmodel, weights, workload)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import CacheConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import Model
from repro_torch.obs.trace import TraceConfig, Tracer
from repro_torch.serving.engine import CachedEngine, Request
from repro_torch.serving.llm_backend import ModelBackend
from repro_torch.serving.scheduler import normalize_query
from repro_torch.serving.server import AsyncCacheServer

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: the traced run profiles the whole batches that start within PROFILE_S
#: from PROFILE_S + 1.5 s before the window closes: late, so that the
#: profiler, which runs on until the last answer, collects few events
#: past the slice (reading each out costs about 0.25 ms)
PROFILE_S = 3.0
#: seconds past the window's close that a late answer is waited for
GRACE_S = 60.0
#: a compared number that could not be read: far past any limit
UNJUDGED = 1e9
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: keys of a configuration's ``deploy`` and of a traffic file that the
#: harness and its references implement in one value only; a file that
#: asks for another is refused, not run as this one
ONLY = {"deploy": {"index": "exact", "key_dtype": "float32",
                   "fused_step": True},
        "traffic": {"arrivals": "poisson"}}


# --------------------------------------------------------------------- #
# the cell: BENCHMARK.json's entry, its cell file, configuration, traffic
# --------------------------------------------------------------------- #
E2E = ("resp_p50_ms", "resp_p95_ms", "answered_qps", "setup_s")


@dataclasses.dataclass
class Cell:
    name: str
    cell: dict           # cells/<name>.json: rate, sample, limits
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    per_layer: list      # BENCHMARK.json's per-layer metrics of this cell
    end_to_end: tuple = E2E   # the end-to-end metrics this cell reports


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}")

    def mine(m):
        return name in m.get("workloads", [name])

    config = json.loads((BENCH / "configs" /
                         f"{entry['config']}.json").read_text())
    traffic = workload.load_traffic(entry["traffic"])
    check_supported(config["deploy"], traffic)
    return Cell(
        name=name,
        cell=json.loads((BENCH / "cells" / f"{name}.json").read_text()),
        config=config, traffic=traffic,
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        end_to_end=tuple(m["name"] for m in bench["end_to_end"]
                         if mine(m)))


def check_supported(deploy: dict, traffic: dict) -> None:
    """Refuse a value of ``ONLY``'s keys that the harness does not run."""
    for part, have in (("deploy", deploy), ("traffic", traffic)):
        for key, value in ONLY[part].items():
            if have.get(key, value) != value:
                raise SystemExit(
                    f"cachebench: {part} {key}={have[key]!r} is not "
                    f"implemented (only {value!r})")


# --------------------------------------------------------------------- #
# the system, with the benchmark's recorders
# --------------------------------------------------------------------- #
class RecordingTokenizer(HashTokenizer):
    """The backend's tokenizer; keeps each row's generated tokens as the
    backend reads them back."""

    def __init__(self, vocab_size: int):
        super().__init__(vocab_size)
        self.generated: list[np.ndarray] = []

    def decode(self, ids) -> str:
        self.generated.append(np.array(ids, dtype=np.int64, copy=True))
        return super().decode(ids)


class _StepRecorder:
    """The engine's cache, with each fused step's matched slots kept (a
    device tensor, read after the window)."""

    def __init__(self, cache):
        self._cache = cache
        self.last_index = None

    def __getattr__(self, name):
        return getattr(self._cache, name)

    def step(self, *args, **kwargs):
        result, runtime = self._cache.step(*args, **kwargs)
        self.last_index = result.index
        return result, runtime


@dataclasses.dataclass
class Served:
    """One served batch: its requests in row order, their responses, the
    host clock around ``serve_batch``, the matched slots, the generated
    tokens of its miss rows (in row order) and its stage seconds."""

    batch: list
    responses: list
    t0: float
    t1: float
    slots: object
    generated: list
    stages: dict


class RecordingEngine(CachedEngine):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.cache = _StepRecorder(self.cache)
        self.served: list[Served] = []
        self.profile_at: float | None = None   # start profiling here
        self.slice: devtrace.Slice | None = None
        self._prof = None

    def _profile(self, t: float, before: bool) -> None:
        """Profile the whole batches that start within ``PROFILE_S`` of
        ``profile_at``. The profiler runs on until ``stop_profile``, after
        the window: reading its events out takes seconds, which would
        stall the server inside the window."""
        if self.profile_at is None:
            return
        if before and self._prof is None and self.slice is None \
                and t >= self.profile_at:
            self._prof = devtrace.Profiler()
            self.slice = devtrace.Slice.begin()
        elif not before and self._prof is not None and not self.slice.t1 \
                and t >= self.profile_at + PROFILE_S:
            torch.cuda.synchronize()
            self.slice.t1 = time.perf_counter()

    def stop_profile(self) -> None:
        if self._prof is not None:
            torch.cuda.synchronize()
            if not self.slice.t1:
                self.slice.t1 = time.perf_counter()
            self.slice.end(self._prof.stop())
            self._prof = None

    def serve_batch(self, batch, **kwargs):
        # the slice begins before the batch's own clock starts, so that the
        # batch that opens it counts among its whole batches
        self._profile(time.perf_counter(), before=True)
        t0 = time.perf_counter()
        tok = self.backend.tokenizer
        n0 = len(tok.generated)
        out = super().serve_batch(batch, **kwargs)
        t1 = time.perf_counter()
        stages: dict[str, float] = {}
        for tr in kwargs.get("traces") or ():
            if tr:
                for s in tr.spans:
                    if s.name not in ("queue_wait", "batch_form"):
                        stages[s.name] = stages.get(s.name, 0.0) + \
                            s.duration_s
                break
        self.served.append(Served(list(batch), out, t0, t1,
                                  self.cache.last_index,
                                  tok.generated[n0:], stages))
        self._profile(time.perf_counter(), before=False)
        return out


@dataclasses.dataclass
class System:
    engine: RecordingEngine
    corpus: list


def build_backend(cell: Cell, seed: int, device) -> ModelBackend:
    """Step 2: the model, its weights made on the device and loaded leaf
    by leaf, behind the backend."""
    mc, dep = cell.config["model"], cell.config["deploy"]
    model = Model(ModelConfig(**mc), device=device)
    for name, leaf in weights.make(mc, seed, device):
        model.load_state_dict({name: leaf}, strict=False)
        del leaf
    backend = ModelBackend(model, RecordingTokenizer(vocab_size=mc["vocab"]),
                           max_prompt_len=dep["max_prompt_len"],
                           max_new_tokens=dep["max_new_tokens"])
    _sync(device)
    return backend


def build_system(cell: Cell, seed: int, device, tracing: bool,
                 phases: dict | None = None, backend=None) -> System:
    """Steps 2-3: the model (or the given ``backend``), a new engine over
    it, its cache warmed with the corpus."""
    phases = {} if phases is None else phases
    t = time.perf_counter()
    dep = cell.config["deploy"]
    if backend is None:
        backend = build_backend(cell, seed, device)
    phases["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    corpus = workload.corpus_for(cell.traffic)
    phases["corpus_s"] = time.perf_counter() - t
    by_id = {p.qa_id: p for p in corpus}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key

    tracer = Tracer(TraceConfig(sample_rate=1.0, head=0,
                                max_traces=1 << 20)) if tracing else None
    engine = RecordingEngine(
        CacheConfig(dim=dep["dim"], capacity=dep["capacity"],
                    value_len=dep["value_len"], threshold=dep["threshold"]),
        backend, judge=judge, batch_size=dep["batch"], device=device,
        tracer=tracer)
    t = time.perf_counter()
    engine.warm(corpus)
    _sync(device)
    phases["warm_s"] = time.perf_counter() - t
    return System(engine=engine, corpus=corpus)


def _request(q: workload.Query) -> Request:
    return Request(query=q.query, category=q.category,
                   source_id=q.source_id, semantic_key=q.semantic_key)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# offering the traffic
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Offered:
    requests: list        # Request objects of the stream, in due order
    due: list             # due times, host clock
    submitted: list       # host clock at submit, None if never
    answered: list        # host clock when the submitter resumed
    responses: list       # Response or None
    errors: list          # repr of an exception or None
    window: tuple         # (t0, t1) host clock


async def _offer(server, requests, due, close_s: float) -> Offered:
    n = len(requests)
    sub, ans, resp, err = [None] * n, [None] * n, [None] * n, [None] * n

    async def one(i):
        sub[i] = time.perf_counter()
        try:
            resp[i] = await server.submit_request(requests[i])
        except Exception as e:          # an answer that never came right
            err[i] = repr(e)
        ans[i] = time.perf_counter()

    tasks = []
    for i in range(n):
        delay = due[i] - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(one(i)))
    await asyncio.wait(tasks, timeout=max(close_s - time.perf_counter(),
                                          0.0))
    for t in tasks:
        if not t.done():
            t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return Offered(requests, due, sub, ans, resp, err, (0.0, 0.0))


def offer(system: System, stream: workload.Stream, *, t_start: float,
          trace: bool, phases: dict | None = None) -> tuple[Offered, float]:
    """Steps 4-5: the warm-up batches, then the stream on its due times.
    Returns what was offered and ``setup_s``."""
    phases = {} if phases is None else phases
    eng = system.engine
    t = time.perf_counter()
    for qs in stream.warmup:
        eng.serve_batch([_request(q) for q in qs])
    dev = eng.device
    _sync(dev)
    phases["warmup_batches_s"] = time.perf_counter() - t
    if trace and dev.type == "cuda":
        # the profiler's first start sets up CUPTI: in set-up, not the slice
        prof = devtrace.Profiler()
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
        prof.stop()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    requests = [_request(q) for q in stream.queries]
    base = time.perf_counter() + 0.05
    due = [base + d for d in stream.due]
    w0 = base + stream.lead_in_s
    w1 = w0 + stream.seconds
    if trace and dev.type == "cuda":
        eng.profile_at = w1 - PROFILE_S - 1.5
    setup_s = due[0] - t_start

    async def go():
        async with AsyncCacheServer(eng) as server:
            got = await _offer(server, requests, due, w1 + GRACE_S)
            # the profiler stops on the thread that started it: the
            # scheduler's one serve worker, idle now that all is answered
            await asyncio.get_running_loop().run_in_executor(
                server.scheduler._executor, eng.stop_profile)
            return got

    got = asyncio.run(go())
    got.window = (w0, w1)
    return got, setup_s


# --------------------------------------------------------------------- #
# end-to-end metrics
# --------------------------------------------------------------------- #
def _quantile(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def in_window(got: Offered) -> list[int]:
    w0, w1 = got.window
    return [i for i, d in enumerate(got.due) if w0 <= d < w1]


def end_to_end(got: Offered, setup_s: float) -> dict:
    """Response times of every request due in the window, from its due
    time (an unanswered one counts as waiting until the grace ran out);
    answers that landed in the window over its length."""
    w0, w1 = got.window
    idx = in_window(got)
    lat = [((got.answered[i] if got.answered[i] is not None else w1 +
             GRACE_S) - got.due[i]) * 1e3 for i in idx]
    answered = sum(1 for a, r in zip(got.answered, got.responses)
                   if r is not None and a is not None and w0 <= a < w1)
    return {"resp_p50_ms": _quantile(lat, 0.50),
            "resp_p95_ms": _quantile(lat, 0.95),
            "answered_qps": answered / (w1 - w0),
            "setup_s": setup_s}


# --------------------------------------------------------------------- #
# judging: the references, after the program is gone
# --------------------------------------------------------------------- #
def _leader_of(got: Offered, i: int, served_at: dict) -> int | None:
    """The request a coalesced one waited on: the latest one before it
    with its key that a batch served."""
    key = normalize_query(got.requests[i].query)
    best = None
    for j in range(i):
        if id(got.requests[j]) in served_at and \
                normalize_query(got.requests[j].query) == key:
            best = j
    return best


def judge_cache(cell: Cell, corpus, served: list[Served], got: Offered,
                device, control: bool = False) -> dict:
    """The cache path, request by request: every served batch replayed in
    order (warm-up included) against ``refcache``. Numbers: requests
    whose hit or miss or matched entry differ; answers that differ (a
    coalesced one from its leader's too); the widest score gap; requests
    due in the window never answered. With ``control`` the TF32 control's
    decisions are judged in the program's place, on the same slab."""
    dep = cell.config["deploy"]
    ref = refcache.CacheReference(dep, cell.config["model"]["vocab"], device)
    ref.warm([p.question for p in corpus], [p.answer for p in corpus])
    tau = dep["threshold"]
    decision = entry = answer = borderline = 0
    score_err = 0.0
    served_at: dict[int, object] = {}
    for b in served:
        rows = [r for r in range(len(b.batch)) if not b.responses[r].cached]
        if len(rows) != len(b.generated):
            decision += 1         # the misses answered are not those sent
        out = ref.serve([r.query for r in b.batch],
                        dict(zip(rows, b.generated)), control=control)
        best = out["best"]
        slots = None if b.slots is None else b.slots.cpu().numpy()
        for r, (req, resp) in enumerate(zip(b.batch, b.responses)):
            served_at[id(req)] = resp
            if control:
                cand = (out["c_hit"][r], out["c_best"][r], out["c_slot"][r],
                        out["c_answer"][r] if out["c_hit"][r]
                        else out["answer"][r], "")
            else:
                cand = (resp.cached, resp.score, None if slots is None
                        else slots[r], resp.answer, resp.error)
            c_hit, c_score, c_slot, c_answer, c_err = cand
            if c_err:
                decision += 1
                continue
            if abs(best[r] - tau) <= 1e-5:
                borderline += 1
            elif bool(c_hit) != bool(out["hit"][r]):
                decision += 1
                continue
            if np.isfinite(best[r]):
                score_err = max(score_err, abs(float(c_score) - best[r]))
            if c_hit:
                s = float(out["scores"][r, int(c_slot)]) \
                    if c_slot is not None else float("-inf")
                if not s >= best[r] - 1e-5:
                    entry += 1
                    continue
            if bool(c_hit) == bool(out["hit"][r]) and \
                    c_answer != out["answer"][r]:
                answer += 1
    coalesced = missing = 0
    for i in in_window(got):
        resp = got.responses[i]
        if resp is None or got.errors[i] is not None or resp.error:
            missing += 1
    for i, resp in enumerate(got.responses):
        if resp is None or not resp.coalesced:
            continue
        j = _leader_of(got, i, served_at)
        lead = None if j is None else served_at[id(got.requests[j])]
        if lead is None or (lead.answer, lead.cached, lead.score) != \
                (resp.answer, resp.cached, resp.score):
            coalesced += 1
    if control:
        coalesced = missing = 0
    return {"cache_mismatch": decision + entry, "answer_mismatch": answer
            + coalesced, "score_err": float(score_err), "unanswered": missing,
            "borderline": borderline}


def model_sample(cell: Cell, served: list[Served], got: Offered,
                 seed: int) -> list[Served]:
    """The window's batches with misses whose rows the model check runs:
    ``cell["model_check"]["batches"]`` of them, drawn from the seed, the
    one with the most misses among them."""
    w0, w1 = got.window
    pool = [b for b in served if b.generated and w0 <= b.t0 < w1]
    if not pool:
        pool = [b for b in served if b.generated]
    k = min(cell.cell["model_check"]["batches"], len(pool))
    rng = random.Random(seed)
    pick = rng.sample(pool, k)
    most = max(pool, key=lambda b: len(b.generated))
    if most not in pick:
        pick[0] = most
    return pick


def judge_model(cell: Cell, sample: list[Served], seed: int, device,
                precision: str = "f32") -> dict:
    """The miss path: the reference run over each sampled batch's prompts
    with the tokens the program served. ``logit_gap``: the widest gap by
    which a served token's logit lies below the reference's best;
    ``token_mismatch``: the share of served tokens more than
    ``refmodel.GAP_EPS`` below it. With ``precision`` not f32, the
    control: that precision's first choice at each position is judged in
    place of the served token."""
    mc, dep = cell.config["model"], cell.config["deploy"]
    w = refmodel.Weights(mc, seed, device)
    tok = refcache.Tokenizer(mc["vocab"])
    widest, tokens, off = 0.0, 0, 0
    for b in sample:
        rows = [r for r in range(len(b.batch)) if not b.responses[r].cached]
        if len(rows) != len(b.generated):
            widest = UNJUDGED     # the misses answered are not those sent
            continue
        prompts = torch.as_tensor(tok.encode_batch(
            [b.batch[r].query for r in rows], dep["max_prompt_len"]),
            device=device)
        served = torch.as_tensor(np.stack(b.generated), device=device)
        logits = refmodel.teacher_logits(w, mc, prompts, served)
        if precision != "f32":
            served = refmodel.teacher_logits(
                w, mc, prompts, served, precision=precision).argmax(-1)
        g = refmodel.gaps(logits, served)
        tokens += g.numel()
        off += int((g > refmodel.GAP_EPS).sum())
        widest = max(widest, float(g.max()))
        del logits
    del w
    return {"logit_gap": widest,
            "token_mismatch": off / tokens if tokens else UNJUDGED,
            "gap_tokens": tokens}


# --------------------------------------------------------------------- #
# per-layer metrics: one reader a metric, found by name
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class TraceView:
    """What a reader gets: the cell, the window's batches, the requests'
    traces, and the profiled slice with its batches."""

    cell: Cell
    batches: list         # Served in the window
    traces: list          # every retained RequestTrace
    slice: devtrace.Slice | None
    slice_batches: list   # Served inside the profiled slice
    end_to_end: dict = dataclasses.field(default_factory=dict)  # all of E2E


def read_per_layer(cell: Cell, view: TraceView) -> dict:
    out = {}
    for m in cell.per_layer:
        v = readers.load(m["name"]).read(view)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# --------------------------------------------------------------------- #
# the run
# --------------------------------------------------------------------- #
def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, log=print) -> dict:
    """One run; returns the result line's fields and the checks."""
    rate = cell.cell["rate_qps"]
    phases = {"imports_s": time.perf_counter() - t_start}
    system = build_system(cell, seed, device, tracing=trace, phases=phases)
    stream = workload.build_stream(cell.traffic, system.corpus, rate,
                                   seconds, seed)
    got, setup_s = offer(system, stream, t_start=t_start, trace=trace,
                         phases=phases)
    log("setup " + json.dumps(phases))
    eng = system.engine
    every = end_to_end(got, setup_s)
    log("window " + json.dumps(every))
    metrics = {k: v for k, v in every.items() if k in cell.end_to_end}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    w0, w1 = got.window
    window_batches = [b for b in eng.served if w0 <= b.t0 < w1]
    info = _earlier_lines(eng, got, window_batches, log)
    view = None
    if trace:
        sl = eng.slice
        view = TraceView(cell, window_batches, eng.tracer.traces(), sl,
                         [] if sl is None else
                         [b for b in eng.served
                          if sl.t0 <= b.t0 and b.t1 <= sl.t1], every)
        per_layer = read_per_layer(cell, view)
        if view.slice_batches:
            info.update(_lookup_kernel(cell, view))
        log("traced " + json.dumps({k: info[k] for k in info
                                    if k.startswith("lookup")}))
    served, corpus = eng.served, system.corpus
    sample = model_sample(cell, served, got, seed)
    # the program's state goes before the references run on the card
    eng.backend = None
    del system, eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = judge_cache(cell, corpus, served, got, device)
    checks.update(judge_model(cell, sample, seed, device))
    info["reference_s"] = time.perf_counter() - t_ref
    log("judged " + json.dumps(checks) + f" in {info['reference_s']:.1f} s")
    if control:
        # the reference in the program's place, a precision below
        low = judge_cache(cell, corpus, served, got, device, control=True)
        low.update(judge_model(cell, sample, seed, device,
                               precision="fp8"))
        info["control"] = low
    attempted = len(in_window(got))
    out = {"metrics": metrics if not trace else per_layer,
           "attempted": attempted, "failed": checks["unanswered"],
           "memory_peak_bytes": int(peak), "checks": checks, "info": info}
    if trace:
        sl = view.slice
        out["busy_s"] = sl.busy_s() if sl else 0.0
        out["window_s"] = sl.window_s if sl else 0.0
        out["breakdown"] = {
            "device_ops": sl.top_ops() if sl else [],
            "idle_gaps": sl.idle_gaps(_host_spans(view.slice_batches))
            if sl else []}
    return out


def _host_spans(batches) -> list:
    """(stage, t0, t1) of each batch's engine stages, laid end to end
    from the batch's start, for naming the device's idle gaps."""
    out = []
    for b in batches:
        t = b.t0
        for name, secs in b.stages.items():
            out.append((name, t, t + secs))
            t += secs
    return out


def _lookup_kernel(cell: Cell, view: TraceView) -> dict:
    """The lookup kernel's device time a batch in the slice, beside its
    bound: the f32 slab read once at the card's bandwidth."""
    dep = cell.config["deploy"]
    n = len(view.slice_batches)
    byts = 4.0 * dep["capacity"] * dep["dim"] + 4.0 * dep["batch"] * \
        dep["dim"]
    return {"lookup_kernel_ms": 1e3 * view.slice.time_of(
        lambda k: "cosine_topk" in k) / n,
        "lookup_bound_ms": 1e3 * byts / counts.PEAK_HBM_BYTES}


def _earlier_lines(eng, got, window_batches, log) -> dict:
    """Table 1's counts, batch shapes and the generator's lateness."""
    idx = in_window(got)
    late = [(got.submitted[i] - got.due[i]) * 1e3 for i in idx
            if got.submitted[i] is not None]
    hits = sum(1 for i in idx if got.responses[i] is not None
               and got.responses[i].cached)
    coal = sum(1 for i in idx if got.responses[i] is not None
               and got.responses[i].coalesced)
    rows = [len(b.batch) for b in window_batches]
    misses = [len(b.generated) for b in window_batches]
    walls = [b.t1 - b.t0 for b in window_batches]
    summ = eng.metrics.summary()
    info = {"offered": len(got.requests), "window_requests": len(idx),
            "window_hits": hits, "window_coalesced": coal,
            "table1": {c: [v["lookups"], v["cache_hits"], v["positive_hits"]]
                       for c, v in summ.get("categories", {}).items()},
            "batches": len(rows),
            "rows_mean": statistics.fmean(rows) if rows else 0.0,
            "misses_mean": statistics.fmean(misses) if misses else 0.0,
            "batch_wall_ms_mean": statistics.fmean(walls) * 1e3
            if walls else 0.0,
            "late_ms_p50": _quantile(late, 0.5) if late else 0.0,
            "late_ms_max": max(late) if late else 0.0}
    log("info " + json.dumps(info))
    return info
