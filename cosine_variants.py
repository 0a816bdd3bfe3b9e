#!/usr/bin/env python3
"""A/B of the shared-mask cosine top-k (PERF.md §6 rows 1 and 2) against
variants of itself, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 cosine_variants.py [--parent FILE.cu] [--out FILE.jsonl]

Each variant is ``src/repro_torch/kernels/csrc/cosine_topk.cu`` (or, with
the ``fma`` prefix, ``--parent``: the revision before the tensor-core form,
whose shared-mask kernel ran f32 FMAs in 64-row tiles,
``git show 36c3f52:src/repro_torch/kernels/csrc/cosine_topk.cu``)
with one choice changed by a text edit, built with ``nvcc`` into
``build/cosine_variants/``, one process each, all at once. Variants that
compute the same function are held against the plain version
(``kernels/ref.py``, ``chip_smoke._compare``): ``cvt.rna`` in place of the
integer TF32 rounding, int8 keys as the plain version's scaled operands
(three products), lo rounded to TF32, no group of four scores skipped, two
stages. Those that drop work on purpose (the top-k offers, the merge
launch, the loads after the pipeline's prologue, two of the three TF32
products) are timed only. Every variant is timed from
CUDA graphs in turns, beside cuBLAS ``q @ keys.T`` alone (TF32 off) and
``torch.topk`` over the masked product, at the main path's shape (B=128,
N=16,384, d=384, k=4, 90% of the slots visible) and at N=1,048,576, for f32
keys, int8 keys (1/127) and int8 keys with per-row scales. Then the
tensor-core and the 4-row plans of this tree's kernel are timed against each
other at smaller N, where ``split()`` chooses between them. Prints one JSON
line per measurement (also written to ``--out``, by default
``build/cosine_variants/cosine_variants.jsonl``) and, last, the card's name
and power limit. The script exits if a source no longer holds a text it
edits.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

from variant_harness import CSRC, ROOT, build, turns

OUT = ROOT / "build" / "cosine_variants"

# ---- this tree's tensor-core form -----------------------------------------
TC_SCAN = ("    __syncthreads();\n    if (k <= SMALL_K) {\n"
           "      // thread tid: row tid % BQ")
TC_WARP = "    } else {\n      // rows past B are the block's last ones"
TC_MERGE = ("  if (err != cudaSuccess || a.chunks == 1 || a.k > tc::SMALL_K) "
            "return launch_merge(a, err);")
TC_INT_ROUND = "  r = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
TC_LO = "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));"
TC_GUARD = ("          if (fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > "
            "ls[SMALL_K - 1]) {")
TC_POST = "  constexpr bool POST_SCALE = sizeof(KT) == 1;"
TC_EXACT = "  constexpr bool EXACT = sizeof(KT) < 4;"
TC_KEY = ("            for (int c = 0; c < 2; ++c)\n"
          "              bh[2 * h + c] = __float_as_uint(stored_f32("
          "kr[kk + t + 4 * c]));\n")
# int8 keys as the plain version's operands: each times its scale (1/127 or
# its row's, read for the key's column), then split like f32 keys
TC_SCALED_KEY = """            for (int c = 0; c < 2; ++c) {
              const float x = stored_f32(kr[kk + t + 4 * c]);
              if constexpr (EXACT) {
                bh[2 * h + c] = __float_as_uint(x);
              } else {
                const int n = min(n0 + wn * WN + (jj + h) * 8 + g, N - 1);
                split_tf32(__fmul_rn(x, SS == ROW_SCALE ? scales[n] : 1.0f / 127.0f),
                           bh[2 * h + c], bl[2 * h + c]);
              }
            }
"""
TC_STAGE = "    if (s + STAGES - 1 < steps) stage(s + STAGES - 1);\n"
TC_PRODUCTS = ("            mma_tf32(part[i][jj + h], al[i], bh[2 * h], "
               "bh[2 * h + 1]);\n"
               "            if constexpr (!EXACT) mma_tf32(part[i][jj + h], "
               "ah[i], bl[2 * h], bl[2 * h + 1]);\n")

TC_STAGES = "constexpr int STAGES = 3;"

# ---- the FMA form before the tensor-core one (--parent) ------------------
P_OFFER = ("        warp_offer(s, n0 + col, s > -INFINITY, k, lane, ls[r], "
           "li[r]);\n")
P_MERGE = "  if (err != cudaSuccess || single) return err;"
P_Q = ("qs[c * (BQ + 1) + r] = (is_row(gr) && gc < d) ? "
       "q[(size_t)gr * d + gc] : 0.0f;")
P_K = ("v = __fmul_rn(static_cast<float>(keys[(size_t)gn * d + gc]), "
       "row_scale[r]);", "v = to_f32(keys[(size_t)gn * d + gc]);")


def _need(src: str, name: str, *texts: str) -> None:
    for text in texts:
        if text not in src:
            raise SystemExit(f"cosine_variants: {name} no longer holds "
                             f"{text!r}")


def variants(src: str, parent: str | None
             ) -> dict[str, tuple[str, str, bool]]:
    """{name: (source, design, computes the same function)}."""
    _need(src, "cosine_topk.cu", TC_SCAN, TC_WARP, TC_MERGE, TC_STAGE,
          TC_PRODUCTS, TC_STAGES, TC_INT_ROUND, TC_LO, TC_GUARD, TC_POST,
          TC_EXACT, TC_KEY)
    out = {
        "tc": (src, "tc", True),
        # the scores still reach the score tile; no list sees them
        "tc_no_offers": (src.replace(TC_SCAN, TC_SCAN.replace(
            "k <= SMALL_K", "k < 0")).replace(TC_WARP, TC_WARP.replace(
                "} else {", "} else if (k < 0) {")), "tc", False),
        "tc_no_merge": (src.replace(TC_MERGE, "  return err;"), "tc", False),
        # TF32 rounding by cvt.rna.tf32.f32, not integer operations
        "tc_cvt_rounding": (src.replace(TC_INT_ROUND, (
            '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));')),
            "tc", True),
        # int8 keys as the plain version's scaled f32 operands, split: three
        # products, not two, and no scale after the sum
        "tc_int8_scaled_operands": (src.replace(TC_POST, (
            "  constexpr bool POST_SCALE = false;")).replace(TC_EXACT, (
                "  constexpr bool EXACT = sizeof(KT) == 2;")).replace(
                    TC_KEY, TC_SCALED_KEY), "tc", True),
        # lo rounded to TF32 too, not left for the tensor cores to truncate
        "tc_lo_rounded": (src.replace(TC_LO, (
            "  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));")),
            "tc", True),
        # every score through the list's compare-exchange, none skipped
        "tc_no_skip": (src.replace(TC_GUARD, "          {"), "tc", True),
        # the pipeline's prologue fills the stages once; no copy after it
        "tc_constant_tiles": (src.replace(TC_STAGE, ""), "tc", False),
        # TF32 alone: hi x hi, about 1e-3 off
        "tc_1xtf32": (src.replace(TC_PRODUCTS, ""), "tc", False),
        "tc_stages2": (src.replace(TC_STAGES, "constexpr int STAGES = 2;"),
                       "tc", True),
    }
    if parent is not None:
        _need(parent, "--parent", P_OFFER, P_MERGE, P_Q, *P_K)
        const = parent.replace(P_Q, "qs[c * (BQ + 1) + r] = 0.01f * c;")
        for text in P_K:
            const = const.replace(text, "v = 0.02f * r;")
        out.update({
            "fma": (parent, "fma", True),
            "fma_no_offers": (parent.replace(P_OFFER, ""), "fma", False),
            "fma_no_merge": (parent.replace(P_MERGE, "  return err;"),
                              "fma", False),
            "fma_constant_tiles": (const, "fma", False),
        })
    return out


def ptxas_lines(log: str) -> list:
    """Registers, spills and shared memory of each tensor-core kernel, and
    of the FMA kernel's shared-mask wide form (BQ=64: ``Li64E`` in the
    mangled name), from nvcc's -Xptxas -v."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entry = name if ("cosine_topk_tc" in name or (
                "cosine_topk_partial" in name
                and re.search(r"Li0ELi[01]ELi64E", name))) else None
        elif entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def parent_split(kmod, b: int, n: int, sms: int) -> tuple[int, int, int]:
    """The plan that the parent revision's ``split()`` gave its shared form
    (``--parent``): 64-row tiles, 4-row ones where 64-row tiles would give
    fewer blocks than SMs, about 4 blocks an SM."""
    wide = -(-b // 64) * -(-n // kmod.BLOCK_N) >= sms
    return kmod.chunking(b, n, sms, 64 if wide else 4, 4)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--out", type=Path,
                        default=OUT / "cosine_variants.jsonl")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cosine_variants: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref

    card = cs.nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    found = variants((CSRC / "cosine_topk.cu").read_text(),
                     None if args.parent is None else args.parent.read_text())
    libs = build({name: text for name, (text, _, _) in found.items()}, OUT,
                 {"tc", "fma"}, ptxas_lines)
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        tail = [i] * 7 + [p] * 5
        lib.cosine_topk_launch.argtypes = [p, p, i, p] + tail
        lib.quant_cosine_topk_launch.argtypes = [p, p, p, p] + tail
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    args.out.parent.mkdir(parents=True, exist_ok=True)
    sink = args.out.open("w")

    def emit(row: dict) -> None:
        row["card"] = card
        print(json.dumps(row), flush=True)
        sink.write(json.dumps(row) + "\n")

    for name, (lib, ptxas) in libs.items():
        emit({"variant": name, "ptxas": ptxas})

    def call(lib, q, slab, valid, k, pl):
        b, d = q.shape
        n = slab[0].shape[0]
        per_chunk, chunks, block_q = pl
        part = [torch.empty((b, chunks, k), dtype=dt, device="cuda")
                if chunks > 1 else None
                for dt in (torch.float32, torch.int32)]
        out_s = torch.empty((b, k), dtype=torch.float32, device="cuda")
        out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
        head = ((q.data_ptr(), slab[0].data_ptr(), slab[1].data_ptr())
                if len(slab) == 2 else
                (q.data_ptr(), slab[0].data_ptr(),
                 kmod.DTYPE_CODE[slab[0].dtype]))
        entry = (lib.quant_cosine_topk_launch if len(slab) == 2
                 else lib.cosine_topk_launch)
        err = entry(*head, valid.data_ptr(), b, n, d, k, per_chunk, chunks,
                    block_q, *(None if t is None else t.data_ptr()
                               for t in part),
                    out_s.data_ptr(), out_i.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"cosine_variants: launch failed ({err})")
        return out_s, out_i

    b, d, k = 128, 384, 4
    for n in (16384, 1048576):
        for dtype in ("f32", "int8", "quant"):
            gen = torch.Generator(device="cuda").manual_seed(7)
            slab, prefix, _ = cs._timing_slab(torch, gen, n, d, dtype)
            q = torch.randn((b, d), generator=gen, device="cuda")
            q = q / q.norm(dim=1, keepdim=True)
            valid = torch.rand(n, generator=gen, device="cuda") < 0.9
            plain = getattr(ref, f"{prefix}cosine_topk_ref")
            rs1, ri1 = plain(q, *slab, valid, k + 1)
            keys_f32 = cs._as_f32(torch, *slab)
            neg = torch.tensor(float("-inf"), device="cuda")
            fns, errs, plans = {}, {}, {}
            for name, (lib, _) in libs.items():
                design, same = found[name][1:]
                pl = (parent_split(kmod, b, n, sms) if design == "fma"
                      else kmod.split(b, n, sms, shared=True))
                plans[name] = pl
                fns[name] = (lambda lib=lib, pl=pl:
                             call(lib, q, slab, valid, k, pl))
                if same:
                    ks, ki = fns[name]()
                    errs[name] = cs._compare(torch, ks, ki, rs1, ri1, k,
                                             cs.SCORE_TOL[dtype],
                                             f"{name} {dtype} N={n}", {})
            fns["cublas_gemm"] = lambda: q @ keys_f32.T
            fns["library"] = lambda: torch.topk(
                torch.where(valid, q @ keys_f32.T, neg), k)
            times = turns(fns, 200 if n <= 16384 else 10)
            for name, runs in times.items():
                emit({"shape": "main" if n == 16384 else "large", "B": b,
                      "N": n, "d": d, "k": k, "key_dtype": dtype,
                      "variant": name, "graph_ms": min(runs),
                      "runs_ms": runs, "plan": plans.get(name),
                      "max_abs_err": errs.get(name)})

    # where split() switches from tensor-core tiles to 4-row ones
    lib = libs["tc"][0]
    for bb in (32, 64, 128):
        for n in (1024, 2048, 4096, 8192):
            gen = torch.Generator(device="cuda").manual_seed(9)
            keys = cs._make_keys(torch, gen, n, d, "f32")
            q = torch.randn((bb, d), generator=gen, device="cuda")
            q = q / q.norm(dim=1, keepdim=True)
            valid = torch.rand(n, generator=gen, device="cuda") < 0.9
            rs1, ri1 = ref.cosine_topk_ref(q, keys, valid, k + 1)
            plans = {"tc_plan": kmod.chunking(bb, n, sms, kmod.BLOCK_Q_TC,
                                              kmod.TC_BLOCKS_PER_SM),
                     "narrow_plan": kmod.chunking(bb, n, sms,
                                                  kmod.BLOCK_Q_NARROW,
                                                  kmod.BLOCKS_PER_SM)}
            fns = {}
            for name, pl in plans.items():
                fns[name] = (lambda pl=pl:
                             call(lib, q, (keys,), valid, k, pl))
                ks, ki = fns[name]()
                cs._compare(torch, ks, ki, rs1, ri1, k, cs.SCORE_TOL["f32"],
                            f"{name} B={bb} N={n}", {})
            times = turns(fns, 200)
            for name, runs in times.items():
                emit({"shape": "crossover", "B": bb, "N": n, "d": d, "k": k,
                      "key_dtype": "f32", "variant": name,
                      "graph_ms": min(runs), "runs_ms": runs,
                      "plan": plans[name],
                      "split_picks": kmod.split(bb, n, sms, shared=True)})
    sink.close()
    print(card)


if __name__ == "__main__":
    main()
