#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:
  card      the card's name and power limit; f32 products must not use TF32
  build     nvcc of every kernel source for sm_90a, with -Xptxas -v
  kernel    each CUDA kernel (shared-mask, per-row interval and dense-mask
            cosine top-k) against its plain PyTorch version on the card
  main      the paper's serve loop (``repro_torch.launch.serve`` defaults)
            on the card for f32 and int8 slabs, with each kernel's launches
            counted, held request by request against the same run on the CPU;
            then the separate lookup+insert path against the fused one
  tenancy   the multi-tenant serve loop (``launch.serve --tenants 4``
            defaults) the same way, through the interval kernel; then
            ``ExactIndex.search`` with a per-row (B, N) mask through the
            dense-mask kernel, against the interval search
  timing    each kernel, its plain version and one PyTorch call computing
            the same function, timed in turns with CUDA events
The last three lines are the card's name and power limit as nvidia-smi
gives them, the per-kernel summary, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SCORE_TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 1e-2}
MAIN_BATCHES = 16          # 2,000 test queries in batches of 128
TENANTS = 4                # launch.serve --tenants 4: 4 x 16,384 slots
KERNELS = ("cosine_topk", "cosine_topk_interval", "cosine_topk_masked")
DECISION_FIELDS = ("lookups", "cache_hits", "hit_rate", "api_call_fraction")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
def phase_card(torch) -> str:
    card = nvidia_smi()
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("torch.backends.cuda.matmul.allow_tf32 is not False")
    if torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmul precision is not 'highest'")
    emit("card", nvidia_smi=card, torch_name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    infos = build.build(force=True)
    for name, info in infos.items():
        entries = []
        for line in info.log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entries.append({"function": m.group(1)})
            elif entries and ("Used" in line or "spill" in line):
                entries[-1].setdefault("ptxas", []).append(line.strip())
        emit("build", kernel=name, seconds=info.seconds, library=str(
            info.path.relative_to(ROOT)), entries=entries)


# --------------------------------------------------------------------- #
def _make_keys(torch, gen, n, d, dtype):
    keys = torch.randn((n, d), generator=gen, device="cuda")
    keys = keys / keys.norm(dim=1, keepdim=True)
    if dtype == "bf16":
        return keys.to(torch.bfloat16)
    if dtype == "int8":
        return torch.clamp(torch.round(keys * 127.0), -127, 127).to(torch.int8)
    return keys


def _as_f32(torch, keys):
    return keys.float() / 127.0 if keys.dtype == torch.int8 else keys.float()


def _compare(torch, ks, ki, rs1, ri1, k, tol, where, tie_rows):
    """Hold a kernel's (scores, ids) against its plain version's top-(k+1)
    (one entry more, for the gap past the kernel's last entry). Returns the
    max abs score error over the finite entries. ``tie_rows`` maps a row to
    the slot ids its planted ties must resolve to, lowest first."""
    torch.cuda.synchronize()
    ks, ki, rs1, ri1 = (x.cpu() for x in (ks, ki, rs1, ri1))
    b = ks.shape[0]
    rs, ri = rs1[:, :k], ri1[:, :k]
    if ks.shape != (b, k) or ki.shape != (b, k):
        fail(f"kernel output shape {tuple(ks.shape)} at {where}")
    empty = ri < 0
    if not torch.equal(empty, ki < 0):
        fail(f"empty slots differ at {where}")
    if not bool(torch.all(torch.isneginf(ks[empty]))):
        fail(f"empty slots without -inf at {where}")
    err = (ks[~empty] - rs[~empty]).abs().max().item() if (~empty).any() \
        else 0.0
    if not err <= tol:
        fail(f"scores differ by {err} > {tol} at {where}")
    # ids must agree wherever the score is apart from both neighbours
    # (including the next entry past the list) by more than the tolerance
    gap = torch.full((b, k + 1), math.inf)
    diff = (rs1[:, 1:] - rs1[:, :-1]).abs()
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    gap[:, :-1] = torch.minimum(gap[:, :-1], diff)
    apart = (gap[:, :k] > tol) & ~empty
    if not torch.equal(ki[apart], ri[apart]):
        fail(f"slot ids differ at {where}")
    for r, want in tie_rows.items():
        want = torch.tensor(want[:k], dtype=torch.int32)
        if not (torch.equal(ki[r, :len(want)], want)
                and torch.equal(ri[r, :len(want)], want)):
            fail(f"planted ties not resolved to the lowest visible slot at "
                 f"{where}: row {r} kernel {ki[r].tolist()}, plain "
                 f"{ri[r].tolist()}, expected {want.tolist()}")
    return err


def _kernel_case(torch, dtype, b, n, d, k, mask, seed):
    """One comparison of the shared-mask kernel with its plain version.
    Returns the max abs score error over the finite entries."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.cosine_topk import cosine_topk_cuda
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = _make_keys(torch, gen, n, d, dtype)
    # planted exact ties: three equal copies of one key row, at slots
    # t0 < t1 < t2, and the first query rows are that row itself
    t0, t1, t2 = n // 5, n // 2, n - 1
    keys[t1] = keys[t0]
    keys[t2] = keys[t0]
    q = torch.randn((b, d), generator=gen, device="cuda")
    n_tie_rows = min(b, 3)
    q[:n_tie_rows] = _as_f32(torch, keys[t0])
    q = q / q.norm(dim=1, keepdim=True)
    ties = torch.tensor([t0, t1, t2], device="cuda")
    if mask == "all":
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
    elif mask == "none":
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
    elif mask == "few":
        # k - 1 visible slots: the three ties and k - 4 others
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
        others = torch.randperm(n, generator=gen, device="cuda")[:k + 3]
        valid[others[~torch.isin(others, ties)][:k - 4]] = True
    else:
        valid = torch.rand(n, generator=gen, device="cuda") < 0.7
    if mask != "none":
        valid[ties] = True
    ks, ki = cosine_topk_cuda(q, keys, valid, k)
    rs1, ri1 = ref.cosine_topk_ref(q, keys, valid, k + 1)
    tie_rows = {} if mask == "none" else \
        {r: [t0, t1, t2] for r in range(n_tie_rows)}
    return _compare(torch, ks, ki, rs1, ri1, k, SCORE_TOL[dtype],
                    f"{dtype} B={b} N={n} d={d} k={k} mask={mask}", tie_rows)


def _intervals(torch, gen, b, n, layout):
    """(starts, sizes) (B,) int32 on the card. ``regions``: TENANTS equal
    contiguous regions, a random one per row, every fifth row empty (a
    padded row); ``random``: random intervals that cross 128-key tiles and
    pass-1 chunks, every fourth row empty; ``empty``: every row empty."""
    if layout == "regions":
        size = n // TENANTS
        tenant = torch.randint(0, TENANTS, (b,), generator=gen, device="cuda")
        starts = tenant * size
        sizes = torch.where(tenant == TENANTS - 1, n - starts, size)
        sizes[4::5] = 0
    elif layout == "random":
        starts = torch.randint(0, n, (b,), generator=gen, device="cuda")
        sizes = (torch.rand(b, generator=gen, device="cuda")
                 * (n - starts + 1)).long().clamp(1, n)
        sizes = torch.minimum(sizes, n - starts)
        sizes[3::4] = 0
    else:
        starts = torch.zeros(b, dtype=torch.long, device="cuda")
        sizes = torch.zeros(b, dtype=torch.long, device="cuda")
    return starts.to(torch.int32), sizes.to(torch.int32)


def _per_row_case(torch, variant, dtype, b, n, d, k, layout, seed):
    """One comparison of the interval (``variant="interval"``) or dense-mask
    (``"masked"``) kernel with its plain version. Planted ties across a
    region edge e: slots e-1, e and e+1 hold one key row; query rows 0, 1, 2
    are that row and see [0, e), [e, n) and [e+1, n), so each must find only
    the copies inside its own interval, lowest slot first. Returns the max
    abs score error."""
    from repro_torch.core.similarity import interval_visibility
    from repro_torch.kernels import ref
    from repro_torch.kernels.cosine_topk import (cosine_topk_interval_cuda,
                                                 cosine_topk_masked_cuda)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = _make_keys(torch, gen, n, d, dtype)
    q = torch.randn((b, d), generator=gen, device="cuda")
    valid = torch.rand(n, generator=gen, device="cuda") < 0.7
    starts, sizes = _intervals(torch, gen, b, n, layout)
    tie_rows = {}
    if layout != "empty" and b >= 3:
        e = n // 3
        keys[e] = keys[e - 1]
        keys[e + 1] = keys[e - 1]
        valid[e - 1:e + 2] = True
        q[:3] = _as_f32(torch, keys[e - 1])
        starts[:3] = torch.tensor([0, e, e + 1], dtype=torch.int32)
        sizes[:3] = torch.tensor([e, n - e, n - e - 1], dtype=torch.int32)
        tie_rows = {0: [e - 1], 1: [e, e + 1], 2: [e + 1]}
    q = q / q.norm(dim=1, keepdim=True)
    if variant == "interval":
        ks, ki = cosine_topk_interval_cuda(q, keys, valid, starts, sizes, k)
        rs1, ri1 = ref.cosine_topk_interval_ref(q, keys, valid, starts, sizes,
                                                k + 1)
    else:
        # a non-contiguous per-row mask: the row's interval and valid slots,
        # a fifth of them knocked out (never the planted ties)
        mask = interval_visibility(valid, starts, sizes) & (
            torch.rand((b, n), generator=gen, device="cuda") < 0.8)
        for r in tie_rows:
            mask[r] = interval_visibility(valid, starts[r:r + 1],
                                          sizes[r:r + 1])[0]
        ks, ki = cosine_topk_masked_cuda(q, keys, mask, k)
        rs1, ri1 = ref.cosine_topk_ref(q, keys, mask, k + 1)
    where = f"{variant} {dtype} B={b} N={n} d={d} k={k} layout={layout}"
    err = _compare(torch, ks, ki, rs1, ri1, k, SCORE_TOL[dtype], where,
                   tie_rows)
    if not bool(torch.all(ki[sizes == 0] == -1)):
        fail(f"a size-0 row did not return (-inf, -1) at {where}")
    return err


def phase_kernel(torch) -> dict:
    """Every kernel against its plain version; returns the worst score
    error of each kernel over its cases."""
    cases = [  # (B, N, d, k, mask)
        (128, 16384, 384, 4, "all"),
        (128, 16384, 384, 4, "random"),
        (1, 1000, 384, 1, "random"),
        (7, 16383, 1536, 8, "random"),
        (200, 16383, 384, 8, "all"),
        (128, 1000, 384, 4, "none"),
        (7, 1000, 1536, 8, "few"),
        (200, 1048576, 384, 4, "random"),
    ]
    per_row_cases = [  # (B, N, d, k, interval layout)
        (128, 65536, 384, 4, "regions"),    # the tenancy path's shape
        (200, 16383, 384, 8, "random"),     # B > 64, N % 128 != 0
        (70, 1000, 1536, 8, "random"),
        (7, 1000, 384, 4, "regions"),
        (128, 1000, 384, 4, "empty"),
        (200, 1048576, 384, 4, "regions"),
    ]
    worst = dict.fromkeys(KERNELS, 0.0)
    for dtype in ("f32", "bf16", "int8"):
        errs = [_kernel_case(torch, dtype, b, n, d, k, mask, seed=1000 + i)
                for i, (b, n, d, k, mask) in enumerate(cases)]
        emit("kernel", kernel="cosine_topk", dtype=dtype, cases=len(cases),
             max_abs_err=max(errs), tolerance=SCORE_TOL[dtype])
        worst["cosine_topk"] = max(worst["cosine_topk"], max(errs))
        for variant in ("interval", "masked"):
            errs = [_per_row_case(torch, variant, dtype, b, n, d, k, layout,
                                  seed=2000 + i)
                    for i, (b, n, d, k, layout) in enumerate(per_row_cases)]
            name = f"cosine_topk_{variant}"
            emit("kernel", kernel=name, dtype=dtype,
                 cases=len(per_row_cases), max_abs_err=max(errs),
                 tolerance=SCORE_TOL[dtype])
            worst[name] = max(worst[name], max(errs))
    return worst


# --------------------------------------------------------------------- #
def _serve(torch, **kw):
    """One ``launch.serve.run``; returns the engine, requests, responses,
    each kernel's launches during the run, and its wall time."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.launch import serve
    kmod.reset_launches()
    t0 = time.perf_counter()
    engine, requests, responses = serve.run(log=lambda *a: None, **kw)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, requests, responses, dict(kmod.launches), wall


def _expect_launches(launches: dict, want: dict, where: str) -> None:
    want = {name: want.get(name, 0) for name in KERNELS}
    if launches != want:
        fail(f"{where}: kernel launches {launches}, expected {want}")


def _same_decisions(a, b, where: str, tol: float) -> None:
    if len(a) != len(b):
        fail(f"{where}: {len(a)} vs {len(b)} responses")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.cached != y.cached or x.answer != y.answer:
            fail(f"{where}: request {i} differs: {x} vs {y}")
        if not abs(x.score - y.score) <= tol:
            fail(f"{where}: request {i} score {x.score} vs {y.score}")


def phase_main(torch) -> int:
    main_launches = None
    for key_dtype in ("f32", "int8"):
        eng, reqs, resp, launches, wall = _serve(torch, device="cuda",
                                                 key_dtype=key_dtype)
        _expect_launches(launches, {"cosine_topk": MAIN_BATCHES},
                         f"main path ({key_dtype})")
        if key_dtype == "f32":
            main_launches = launches["cosine_topk"]
        scores = [r.score for r in resp]
        if len(resp) != len(reqs) or not all(
                math.isfinite(s) for s in scores):
            fail(f"main path ({key_dtype}): missing or non-finite scores")
        cpu, _, cpu_resp, cpu_launches, cpu_wall = _serve(
            torch, device="cpu", key_dtype=key_dtype)
        _expect_launches(cpu_launches, {}, "the CPU run")
        _same_decisions(resp, cpu_resp, f"main {key_dtype} cuda vs cpu", 1e-5)
        cats = eng.metrics.summary()["categories"]
        if cats != cpu.metrics.summary()["categories"]:
            fail(f"main {key_dtype}: per-category summary differs from CPU")
        gap = min(abs(s - 0.8) for s in scores)
        # host share of the serve path: embedding the served queries alone
        t0 = time.perf_counter()
        eng.embedder.embed_batch([r.query for r in reqs])
        embed_s = time.perf_counter() - t0
        emit("main", key_dtype=key_dtype, device="cuda", requests=len(resp),
             batches=MAIN_BATCHES, kernel_launches=launches,
             wall_s=wall, wall_per_batch_s=wall / MAIN_BATCHES,
             serve_path_s=eng.metrics.cache_path_time_s,
             embed_queries_s=embed_s,
             cpu_wall_s=cpu_wall, closest_score_to_threshold=gap,
             table1={c: {"hits": m["cache_hits"], "lookups": m["lookups"],
                         "hit_rate": m["hit_rate"],
                         "positive_rate": m["positive_rate"]}
                     for c, m in cats.items()})
    quick = dict(corpus=400, queries=100, device="cuda")
    _, _, fused, fl, _ = _serve(torch, fused=True, **quick)
    _, _, sep, sl, _ = _serve(torch, fused=False, **quick)
    _same_decisions(fused, sep, "separate vs fused", 1e-6)
    _expect_launches(fl, {"cosine_topk": 4}, "quick config, fused")
    _expect_launches(sl, {"cosine_topk": 4}, "quick config, separate")
    emit("main", check="separate path equals fused", requests=len(fused),
         launches_fused=fl["cosine_topk"], launches_separate=sl["cosine_topk"])
    return main_launches


# --------------------------------------------------------------------- #
def _untimed_tenants(summary: dict) -> dict:
    """``summary()["tenants"]`` without its wall-clock percentiles."""
    return {name: {**{k: v for k, v in t.items()
                      if k != "latency_percentiles"},
                   "latency_counts": {p: r["count"] for p, r in
                                      t["latency_percentiles"].items()}}
            for name, t in summary["tenants"].items()}


def _per_row_search(torch, eng, reqs):
    """ExactIndex.search on the card with a per-row (B, N) ``alive`` mask
    (the dense-mask kernel) against the same search with interval operands
    (the interval kernel), over the served requests in batches of 128.
    Returns the launches of the dense-mask run and the batches searched."""
    from repro_torch.core import store
    from repro_torch.core.similarity import interval_visibility
    from repro_torch.kernels import cosine_topk as kmod
    cache, rt = eng.cache, eng.runtime
    alive = store.alive_mask(rt.state, eng._now)
    batches = 0
    masked_launches = dict.fromkeys(KERNELS, 0)
    for i in range(0, len(reqs), eng.batcher.batch_size):
        chunk = reqs[i:i + eng.batcher.batch_size]
        q = eng._embed([r.query for r in chunk])
        interval = cache._tenant_interval(eng._tenant_ids(chunk))
        kmod.reset_launches()
        ds, di = cache.index.search(rt.index_state, q, rt.state.keys,
                                    interval_visibility(alive, *interval))
        torch.cuda.synchronize()
        for name, n in kmod.launches.items():
            masked_launches[name] += n
        its, iti = cache.index.search(rt.index_state, q, rt.state.keys,
                                      alive, interval=interval)
        cs, ci = cache.index.search(
            rt.index_state, q.cpu(), rt.state.keys.cpu(), alive.cpu(),
            interval=tuple(x.cpu() for x in interval))
        if not (torch.equal(ds, its) and torch.equal(di, iti)):
            fail("per-row (B, N) search differs from the interval search")
        if not torch.equal(di.cpu(), ci) or not bool(torch.all(
                (ds.cpu() == cs) | ((ds.cpu() - cs).abs() <= 1e-5))):
            fail("per-row (B, N) search on the card differs from the CPU")
        batches += 1
    return masked_launches, batches


def phase_tenancy(torch) -> dict:
    """The multi-tenant serve path on the card, against the CPU. Returns
    the interval and dense-mask kernels' launches on their paths."""
    out = {}
    for key_dtype in ("f32", "int8"):
        kw = dict(tenants=TENANTS, key_dtype=key_dtype)
        eng, reqs, resp, launches, wall = _serve(torch, device="cuda", **kw)
        _expect_launches(launches, {"cosine_topk_interval": MAIN_BATCHES},
                         f"tenancy path ({key_dtype})")
        scores = [r.score for r in resp]
        if len(resp) != len(reqs) or not all(
                math.isfinite(s) for s in scores):
            fail(f"tenancy path ({key_dtype}): missing or non-finite scores")
        cpu, _, cpu_resp, cpu_launches, cpu_wall = _serve(
            torch, device="cpu", **kw)
        _expect_launches(cpu_launches, {}, "the CPU tenancy run")
        _same_decisions(resp, cpu_resp, f"tenancy {key_dtype} cuda vs cpu",
                        1e-5)
        summ, dev = eng.metrics.summary(), eng.tenant_stats()
        if _untimed_tenants(summ) != _untimed_tenants(cpu.metrics.summary()):
            fail(f"tenancy {key_dtype}: per-tenant summary differs from CPU")
        # the hit decisions per category must agree; the judged share of
        # the hits may not: two slots of distinct keys and provenance can
        # score the same f32 value in one summation order and not in the
        # other, and the kernel and the CPU then match different ones
        cats = {dev_name: {c: {f: m[f] for f in DECISION_FIELDS} for c, m
                           in e.metrics.summary()["categories"].items()}
                for dev_name, e in (("cuda", eng), ("cpu", cpu))}
        if cats["cuda"] != cats["cpu"]:
            fail(f"tenancy {key_dtype}: per-category hits differ from CPU")
        positives = {dev_name: {c: m["positive_hits"] for c, m in
                                e.metrics.summary()["categories"].items()}
                     for dev_name, e in (("cuda", eng), ("cpu", cpu))}
        if dev != cpu.tenant_stats():
            fail(f"tenancy {key_dtype}: tenant_stats differ from CPU")
        for name, row in summ["tenants"].items():
            if (row["lookups"], row["cache_hits"]) != \
                    (dev[name]["lookups"], dev[name]["hits"]):
                fail(f"tenancy {key_dtype}: host and device counters of "
                     f"{name} disagree")
        if sum(r["lookups"] for r in dev.values()) != len(reqs):
            fail(f"tenancy {key_dtype}: lookups do not add up to requests")
        cfg = eng.cache.config
        emit("tenancy", key_dtype=key_dtype, device="cuda",
             tenants=TENANTS, capacity=cfg.capacity,
             slab_mb=eng.state.keys.numel() * eng.state.keys.element_size()
             / 1e6, requests=len(resp), batches=MAIN_BATCHES,
             kernel_launches=launches, wall_s=wall,
             wall_per_batch_s=wall / MAIN_BATCHES,
             serve_path_s=eng.metrics.cache_path_time_s, cpu_wall_s=cpu_wall,
             closest_score_to_threshold=min(abs(s - 0.8) for s in scores),
             positive_hits=positives,
             per_tenant={name: {"lookups": r["lookups"], "hits": r["hits"],
                                "hit_rate": summ["tenants"][name]["hit_rate"],
                                "inserts": r["inserts"],
                                "evictions": r["evictions"],
                                "region_slots": r["region_slots"]}
                         for name, r in dev.items()})
        if key_dtype == "f32":
            out["cosine_topk_interval"] = launches["cosine_topk_interval"]
            masked, batches = _per_row_search(torch, eng, reqs)
            _expect_launches(masked, {"cosine_topk_masked": batches},
                             "per-row (B, N) ExactIndex.search")
            out["cosine_topk_masked"] = batches
            emit("tenancy", check="ExactIndex.search with a (B, N) alive "
                 "equals the interval search and the CPU", batches=batches,
                 kernel_launches=masked)
    quick = dict(corpus=100, queries=100, tenants=TENANTS, device="cuda")
    fe, _, fused, fl, _ = _serve(torch, fused=True, **quick)
    se, _, sep, sl, _ = _serve(torch, fused=False, **quick)
    _same_decisions(fused, sep, "tenancy separate vs fused", 1e-6)
    if fe.tenant_stats() != se.tenant_stats():
        fail("tenancy separate vs fused: tenant_stats differ")
    _expect_launches(fl, {"cosine_topk_interval": 4}, "tenancy quick, fused")
    _expect_launches(sl, {"cosine_topk_interval": 4},
                     "tenancy quick, separate")
    emit("tenancy", check="separate path equals fused", requests=len(fused),
         launches_fused=fl, launches_separate=sl)
    return out


# --------------------------------------------------------------------- #
def _time(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_turns(torch, fns: dict, reps: int) -> tuple[dict, dict]:
    """Each function timed in turns (a, b, c, c, b, a); best of the two."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(_time(torch, fns[name], reps))
    return {name: sorted(v)[0] for name, v in times.items()}, times


def _bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def phase_timing(torch, card: str) -> dict:
    from repro_torch.core.similarity import interval_visibility
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    out = {}
    b, d, k = 128, 384, 4
    neg = torch.tensor(float("-inf"), device="cuda")
    for n, dtype in ((16384, "f32"), (16384, "int8"),
                     (1048576, "f32"), (1048576, "int8")):
        gen = torch.Generator(device="cuda").manual_seed(7)
        keys = _make_keys(torch, gen, n, d, dtype)
        q = torch.randn((b, d), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9

        def kernel():
            return kmod.cosine_topk_cuda(q, keys, valid, k)

        def plain():
            return ref.cosine_topk_ref(q, keys, valid, k)

        def library():
            return torch.topk(torch.where(valid, q @ _as_f32(torch, keys).T,
                                          neg), k)

        reps = 200 if n <= 16384 else 10
        ms, times = _time_turns(torch, {"kernel": kernel, "plain": plain,
                                        "library": library}, reps)
        bound = _bound(2.0 * b * n * d,
                       b * d * 4 + n * d * keys.element_size() + n + b * k * 8)
        row = {"kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
               "library_ms": ms["library"], "runs_ms": times, **bound,
               "share_of_bound": bound["bound_ms"] / ms["kernel"],
               "l2_warm": n * d * keys.element_size() < 50e6}
        out[("cosine_topk", n, dtype)] = row
        emit("timing", kernel="cosine_topk", B=b, N=n, d=d, k=k,
             key_dtype=dtype, card=card, **row)

    # the per-row kernels at the tenancy path's shape (4 regions of 16,384)
    # and at N = 1,048,576 (4 regions of 262,144): each row sees one region
    for n, dtype in ((65536, "f32"), (65536, "int8"),
                     (1048576, "f32"), (1048576, "int8")):
        gen = torch.Generator(device="cuda").manual_seed(11)
        keys = _make_keys(torch, gen, n, d, dtype)
        q = torch.randn((b, d), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9
        size = n // TENANTS
        starts = (torch.arange(b, device="cuda") % TENANTS
                  * size).to(torch.int32)
        sizes = torch.full((b,), size, dtype=torch.int32, device="cuda")
        mask = interval_visibility(valid, starts, sizes)
        el = keys.element_size()
        reps = 100 if n <= 65536 else 10
        # visible work only: each row scores its own region; the slab
        # bytes are those of the union of the intervals (here all of N)
        union = int(interval_visibility(
            torch.ones(n, dtype=torch.bool, device="cuda"), starts,
            sizes).any(0).sum())
        visible = int(sizes.long().sum())
        for variant in ("interval", "masked"):
            name = f"cosine_topk_{variant}"
            if variant == "interval":
                operands = (valid, starts, sizes)

                def kernel():
                    return kmod._launch(name, q, keys, operands, k)

                def wrapper():
                    return kmod.cosine_topk_interval_cuda(
                        q, keys, valid, starts, sizes, k)

                def plain():
                    return ref.cosine_topk_interval_ref(q, keys, valid,
                                                        starts, sizes, k)

                def library():
                    cols = torch.arange(n, device="cuda")[None, :]
                    inside = (cols >= starts[:, None]) & \
                        (cols < (starts + sizes)[:, None])
                    return torch.topk(torch.where(
                        valid[None] & inside, q @ _as_f32(torch, keys).T,
                        neg), k)
                nbytes = (b * d * 4 + union * (d * el + 1) + 2 * b * 4
                          + b * k * 8)
            else:
                def kernel():
                    return kmod._launch(name, q, keys, (mask,), k)

                def wrapper():
                    return kmod.cosine_topk_masked_cuda(q, keys, mask, k)

                def plain():
                    return ref.cosine_topk_ref(q, keys, mask, k)

                def library():
                    return torch.topk(torch.where(
                        mask, q @ _as_f32(torch, keys).T, neg), k)
                nbytes = b * d * 4 + union * d * el + b * n + b * k * 8
            ms, times = _time_turns(torch, {"kernel": kernel,
                                            "wrapper": wrapper,
                                            "plain": plain,
                                            "library": library}, reps)
            bound = _bound(2.0 * d * visible, nbytes)
            row = {"kernel_ms": ms["kernel"], "wrapper_ms": ms["wrapper"],
                   "plain_ms": ms["plain"], "library_ms": ms["library"],
                   "runs_ms": times, **bound,
                   "share_of_bound": bound["bound_ms"] / ms["kernel"],
                   "l2_warm": n * d * el < 50e6}
            out[(name, n, dtype)] = row
            emit("timing", kernel=name, B=b, N=n, d=d, k=k, key_dtype=dtype,
                 regions=TENANTS, card=card, **row)
    return out


# --------------------------------------------------------------------- #
def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(SRC))

    card = phase_card(torch)
    phase_build()
    max_err = phase_kernel(torch)
    launches = {"cosine_topk": phase_main(torch), **phase_tenancy(torch)}
    timing = phase_timing(torch, card)
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    # each kernel at the shape of the path that launches it, f32 slab
    rows = {"cosine_topk": (16384, "src/repro/kernels/cosine_topk.py:218"),
            "cosine_topk_interval":
            (65536, "src/repro/kernels/cosine_topk.py:251"),
            "cosine_topk_masked":
            (65536, "src/repro/kernels/cosine_topk.py:286")}
    kernels = []
    for name, (n, replaces) in rows.items():
        row = timing[(name, n, "f32")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cosine_topk.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    summary = {"kernels": kernels}
    print(nvidia_smi())
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
