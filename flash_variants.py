#!/usr/bin/env python3
"""A/B of the flash-attention kernels (PERF.md §6 rows 9 and 9b) against
variants of themselves, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 flash_variants.py
    python3 flash_variants.py --bwd [--parent FILE.cu] [--out FILE.jsonl]

Without ``--bwd``: each variant is
``src/repro_torch/kernels/csrc/flash_attention.cu`` with one design choice
of the bf16 forward undone by a text edit (the exponential, the
normalization, the visibility test, the blocks an SM), built with ``nvcc``
into ``build/flash_variants/``, held against the plain version at the
serve shape and on four other shapes, and timed from CUDA graphs at the
serve shape (B=39, L=64 causal, H=32, HKV=4, D=128) in turns with
``scaled_dot_product_attention``. Prints one JSON line per variant and the
card's name and power limit.

With ``--bwd``, the backward (row 9b) at the two training shapes
(qwen2-vl-2b: B=8, L=128, H=12, HKV=2, D=128; musicgen-large: B=4, L=192,
H=HKV=32, D=64; bf16, causal):

  new             this tree's kernels at the wrapper's plan (``bwd_plan``)
  new_one_slice   the same library with one slice a key tile (no partials)
  new_bf16_only   P and dS rounded to bf16 alone: the MMAs of their low
                  parts left out (held, not required within tolerance)
  new_dkdv_only, new_dq_only
                  the bf16 launch with the dQ blocks, or the dK/dV blocks,
                  returning at once (timed only)
  new_s{S-1}, new_s{S+1}
                  this tree's kernels at one slice fewer and one more than
                  the plan's S, where S > 2
  parent          ``--parent``, the design before: the CUDA-core
                  kernels of ``git show 2f36460:src/repro_torch/kernels/
                  csrc/flash_attention.cu > build/flash_pr25.cu``
  sdpa            SDPA's backward, one ATen call with K and V expanded to H
                  heads (``chip_smoke._sdpa_bwd``)

each held against ``ref.flash_attention_bwd_ref`` (``chip_smoke.BWD_TOL``)
and run twice for the same bits, timed from CUDA graphs in turns
(``variant_harness.turns``), and broken down by kernel with
``torch.profiler`` (device time a call). Prints the ``ptxas`` registers and
spills of every backward kernel, one JSON line per measurement (also
written to ``--out``, by default ``build/flash_variants/bwd.jsonl``) and,
last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

from variant_harness import CSRC, ROOT, build, ptxas_after, turns

OUT = ROOT / "build" / "flash_variants"

EXP = ("__expf(m[r] - m_new)", "__expf(x - m_new)")
NORM = {"o[j][0] * inv0, o[j][1] * inv0":
        "o[j][0] / fmaxf(l[0], 1e-30f), o[j][1] / fmaxf(l[0], 1e-30f)",
        "o[j][2] * inv1, o[j][3] * inv1":
        "o[j][2] / fmaxf(l[1], 1e-30f), o[j][3] / fmaxf(l[1], 1e-30f)"}
MASK_ROW = """      // key k0 + 2 tig + kr is visible when kr <= hi and kr >= lo (the
      // window) or kr <= sk (a sink)
      const int hi = min(a.Lk - 1, a.causal ? qp : a.Lk) - k0 - 2 * tig;
      const int lo = a.window > 0 ? qp - a.window + 1 - k0 - 2 * tig : -BK;
      const int sk = a.n_sink - 1 - k0 - 2 * tig;
"""
MASK_ELEM = """          const int kr = 8 * j + e;
          const bool vis = j < n_live && kr <= hi && (kr >= lo || kr <= sk);
"""
MASK_ELEM_PLAIN = """          const int kp = k0 + 8 * j + 2 * tig + e;
          bool vis = j < n_live && kp < a.Lk;
          if (a.causal) vis = vis && kp <= qp;
          if (a.window > 0) vis = vis && (kp > qp - a.window || kp < a.n_sink);
"""
BLOCKS = "constexpr int TC_MIN_BLOCKS = 3;"


def variants(src: str) -> dict[str, str]:
    """The source and each variant of it: one design choice undone."""
    for text in EXP + tuple(NORM) + (MASK_ROW, MASK_ELEM, BLOCKS):
        if text not in src:
            raise SystemExit(f"flash_attention.cu no longer holds {text!r}")
    division = src
    for text, by in NORM.items():
        division = division.replace(text, by)
    exact = src
    for text in EXP:
        exact = exact.replace(text, text.replace("__expf", "expf"))
    return {
        "kernel": src,
        "exact_expf": exact,
        "division": division,
        "per_element_mask": src.replace(MASK_ROW, "").replace(
            MASK_ELEM, MASK_ELEM_PLAIN),
        "four_blocks_an_sm": src.replace(BLOCKS,
                                         "constexpr int TC_MIN_BLOCKS = 4;"),
        "two_blocks_an_sm": src.replace(BLOCKS,
                                        "constexpr int TC_MIN_BLOCKS = 2;"),
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--bwd", action="store_true")
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--out", type=Path, default=OUT / "bwd.jsonl")
    args = parser.parse_args()
    if args.parent is not None and not args.bwd:
        raise SystemExit("flash_variants: --parent takes --bwd")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ref

    card = cs.nvidia_smi()
    if args.bwd:
        bwd_main(torch, cs, ref, card, args)
    else:
        fwd_main(torch, cs, ref, card)
    print(card)


def fwd_main(torch, cs, ref, card: str) -> None:
    import torch.nn.functional as F
    found = variants((CSRC / "flash_attention.cu").read_text())
    # the D=128 bf16 kernel's registers and spills
    libs = build(found, OUT, set(found),
                 ptxas_after(lambda line: "bf16_kernelILi128" in line))
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 10 + [
            ctypes.c_float, p]
        lib.flash_attention_launch.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(47)

    def call(lib, q, k, v, window=None):
        out = torch.empty_like(q)
        b, lq, h, d = q.shape
        lk, hkv = k.shape[1], k.shape[2]
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 1,
            b, lq, lk, h, hkv, d, 1, -1 if window is None else window, 0,
            1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"flash_variants: launch failed ({err})")
        return out

    shapes = [(39, 64, 64, 32, 4, 128, None), (2, 100, 100, 8, 8, 64, None),
              (2, 256, 256, 8, 2, 128, 100), (2, 100, 256, 8, 1, 64, 80),
              (3, 200, 200, 16, 2, 128, None)]
    operands = []
    for b, lq, lk, h, hkv, d, window in shapes:
        q, k, v = cs._attn_inputs(torch, gen, ((b, lq, h, d), (b, lk, hkv, d),
                                               (b, lk, hkv, d)),
                                  torch.bfloat16)
        operands.append((q, k, v, window,
                         ref.flash_attention_ref(q, k, v, window=window)))
    errs = {}
    for name, (lib, _) in libs.items():
        errs[name] = max(cs._attn_err(torch, call(lib, q, k, v, window), want,
                                      "bf16", f"{name} {shape}")
                         for (q, k, v, window, want), shape
                         in zip(operands, shapes))

    q, k, v, _, _ = operands[0]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {name: (lambda lib=lib: call(lib, q, k, v))
           for name, (lib, _) in libs.items()}
    fns["sdpa"] = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    times = turns(fns, 200)
    for name, runs in times.items():
        print(json.dumps({"variant": name, "graph_ms": min(runs),
                          "runs_ms": runs, "max_abs_err": errs.get(name),
                          "ptxas": libs[name][1] if name in libs else None,
                          "card": card}), flush=True)


# ---- the backward (--bwd) -------------------------------------------------
BWD_SHAPES = {"qwen2-vl-2b": (8, 128, 12, 2, 128),
              "musicgen-large": (4, 192, 32, 32, 64)}
# the MMAs of P's and dS's low bf16 parts
BWD_LO = re.compile(r"^ *mma_bf16\((?:dv|dk|dq)\[2 \* dt(?: \+ 1)?\], (?:pl|sl), "
                    r".*\);\n", re.M)


def bwd_ptxas(log: str) -> dict[str, str]:
    """Each backward kernel's spill and register lines, by its mangled
    name's kernel and template arguments."""
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*?(flash_bwd_\w+?kernel)I"
                      r"(\w+?)EEvNS", line)
        if m:
            out[f"{m.group(1)}<{m.group(2)}>"] = " | ".join(
                x.strip() for x in lines[i + 1:i + 3])
    return out


# the bf16 launch's two kinds of block: dK/dV first, then dQ
BWD_DKDV_CALL = "    bwd_dkdv_bf16<D>(a, "
BWD_DQ_BRANCH = "  } else {\n    const long long j = i - n_dkdv;"


def bwd_variants(src: str, parent: str | None) -> dict[str, str]:
    if len(BWD_LO.findall(src)) != 6:
        raise SystemExit("flash_attention.cu no longer holds the six "
                         "low-part MMAs of the backward")
    for text in (BWD_DKDV_CALL, BWD_DQ_BRANCH):
        if text not in src:
            raise SystemExit(f"flash_attention.cu no longer holds {text!r}")
    found = {"new": src, "new_bf16_only": BWD_LO.sub("", src),
             "new_dkdv_only": src.replace(BWD_DQ_BRANCH, BWD_DQ_BRANCH.replace(
                 "} else {", "} else if (false) {")),
             "new_dq_only": src.replace(BWD_DKDV_CALL,
                                        "    return;\n" + BWD_DKDV_CALL)}
    if parent is not None:
        found["parent"] = parent
    return found


def bwd_main(torch, cs, ref, card: str, args) -> None:
    from repro_torch.kernels import flash_attention as kflash
    found = bwd_variants((CSRC / "flash_attention.cu").read_text(),
                         None if args.parent is None
                         else args.parent.read_text())
    libs = build(found, OUT, {"new", "parent"}, bwd_ptxas)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, _) in libs.items():
        lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 10 + [
            ctypes.c_float, p]
        if name == "parent":   # the PR 25 source's one entry point
            lib.flash_attention_bwd_launch.argtypes = [p] * 10 + [i] * 10 + [
                ctypes.c_float, p]
        else:
            lib.flash_attention_bwd_split_launch.argtypes = [p] * 11 + [
                i] * 11 + [ctypes.c_float, p]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    sink = args.out.open("w")

    def emit(row: dict) -> None:
        row["card"] = card
        print(json.dumps(row), flush=True)
        sink.write(json.dumps(row) + "\n")

    for name, (_, ptxas) in libs.items():
        emit({"variant": name, "ptxas": ptxas})
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def forward(q, k, v, name="new", with_lse=True):
        b, lq, h, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, lq), dtype=torch.float32, device="cuda")
        err = libs[name][0].flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, 1, b, lq, k.shape[1], h,
            k.shape[2], d, 1, -1, 0, 1.0 / d ** 0.5, stream())
        if err != 0:
            raise SystemExit(f"flash_variants: forward launch failed ({err})")
        return out, lse

    def backward(name, splits, q, k, v, out, dout, lse):
        """The backward of library ``name``; ``splits`` None: the parent's
        entry point (no slices)."""
        lib = libs[name][0]
        b, lq, h, d = q.shape
        lk, hkv = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        di = torch.empty((b, h, lq), dtype=torch.float32, device="cuda")
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), di.data_ptr())
        tail = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, b, lq, lk, h,
                hkv, d, 1, -1, 0)
        if splits is None:
            err = lib.flash_attention_bwd_launch(*head, *tail, 1.0 / d ** 0.5,
                                                 stream())
        else:
            part = torch.empty(2 * splits * b * lk * hkv * d,
                               dtype=torch.float32, device="cuda") \
                if splits > 1 else None
            err = lib.flash_attention_bwd_split_launch(
                *head, None if part is None else part.data_ptr(), *tail,
                splits, 1.0 / d ** 0.5, stream())
        if err != 0:
            raise SystemExit(f"flash_variants: backward launch failed ({err})")
        return dq, dk, dv

    def per_kernel(fn, calls=20) -> dict[str, float]:
        """Device ms a call of each kernel ``fn`` launches, by name."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if t > 0:
                out[e.key[:90]] = t / calls / 1e3
        return out

    gen = torch.Generator(device="cuda").manual_seed(67)
    if "parent" in libs:
        # row 9's forward (the serve path: no log-sum-exp) in both sources,
        # bit for bit, at the serve shape
        q, k, v = cs._attn_inputs(torch, gen, ((40, 64, 32, 128),
                                               (40, 64, 4, 128),
                                               (40, 64, 4, 128)),
                                  torch.bfloat16)
        same = torch.equal(forward(q, k, v, "new", False)[0],
                           forward(q, k, v, "parent", False)[0])
        emit({"check": "row 9's forward at the serve shape, this tree vs "
              "--parent", "bitwise_equal": same})
        if not same:
            raise SystemExit("flash_variants: the forward's output moved")
    for shape_name, (b, l, h, hkv, d) in BWD_SHAPES.items():
        q, k, v, dout = cs._attn_inputs(torch, gen, (
            (b, l, h, d), (b, l, hkv, d), (b, l, hkv, d), (b, l, h, d)),
            torch.bfloat16)
        out, lse = forward(q, k, v)
        plan = kflash.bwd_plan(b, l, l, h, hkv, d, n_sm)
        # (source, slices); variants of the plan's slices next to it
        runs = {"new": ("new", plan.splits), "new_one_slice": ("new", 1),
                "new_bf16_only": ("new_bf16_only", plan.splits),
                "new_dkdv_only": ("new_dkdv_only", plan.splits),
                "new_dq_only": ("new_dq_only", plan.splits),
                "parent": ("parent", None)}
        if plan.splits > 2:
            runs.update({f"new_s{s}": ("new", s)
                         for s in (plan.splits - 1, plan.splits + 1)})
        fns = {name: (lambda src=src, s=splits:
                      backward(src, s, q, k, v, out, dout, lse))
               for name, (src, splits) in runs.items() if src in libs}
        fns["sdpa"] = cs._sdpa_bwd(torch, q, k, v, dout)
        f32 = [x.float() for x in (q, k, v, out, dout)]
        want = ref.flash_attention_bwd_ref(*f32, lse)
        errs = {}
        for name, fn in fns.items():
            if name in ("sdpa", "new_dkdv_only", "new_dq_only"):
                continue   # timed only: half of the gradients left unwritten
            got, again = fn(), fn()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SystemExit(f"flash_variants: two runs of {name} differ")
            errs[name] = [float((g.float() - w).abs().max())
                          / float(w.abs().max()) for g, w in zip(got, want)]
            if name != "new_bf16_only" and max(errs[name]) > cs.BWD_TOL["bf16"]:
                raise SystemExit(f"flash_variants: {name} {shape_name} "
                                 f"differs from the plain version: {errs[name]}")
        bound = cs._bwd_bound(q, k, l * (l + 1) // 2)
        times = turns(fns, 50)
        for name, t in times.items():
            emit({"variant": name, "shape": shape_name, "B": b, "L": l, "H": h,
                  "HKV": hkv, "D": d, "graph_ms": min(t), "runs_ms": t,
                  "share_of_bound": bound["bound_ms"] / min(t),
                  "bound_ms": bound["bound_ms"],
                  "splits": (runs[name][1] or 1) if name in runs else None,
                  "plan": plan._asdict() if name.startswith("new") else None,
                  "rel_err_dq_dk_dv": errs.get(name),
                  "kernels_ms": per_kernel(fns[name])})


if __name__ == "__main__":
    main()
