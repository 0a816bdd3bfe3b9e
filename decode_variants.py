#!/usr/bin/env python3
"""A/B of the decode-attention kernel against variants of itself, on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 decode_variants.py [--source FILE.cu]

Each variant is ``src/repro_torch/kernels/csrc/decode_attention.cu`` (or
``--source``, another revision of it) with one choice changed by a text
edit, built with ``nvcc`` into ``build/decode_variants/``. The variants
that compute the same function are held against the plain version; those
that drop work on purpose (a loop removed, constant keys) are timed only.
Every variant is timed from CUDA graphs in turns with
``scaled_dot_product_attention``, also from a graph, at the serve shape:
B=39, S=96 with 76 visible slots, H=32, HKV=4, D=128, bf16. The split
kernel is also timed at B=20 (about the fewest misses a batch) and at B=8,
S=4096, all visible (yi-6b's context), each also with other split counts
than its wrapper chooses. Prints one JSON line per
variant and the card's name and power limit.

Two revisions are known: the split kernel of this tree, and the one-block-
per-(b, kv-head) kernel before it, which ``--source`` takes from git:
``git show d19f58e:src/repro_torch/kernels/csrc/decode_attention.cu``.
The script exits if the source holds neither's texts.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from variant_harness import CSRC, ROOT, build, ptxas_after, turns

OUT = ROOT / "build" / "decode_variants"

# ---- the one-block-per-(b, kv-head) kernel (serial loads per slot) ------
SERIAL_MARK = "constexpr int TS = 64;         // cache slots per tile"
SERIAL_PV = "for (int j = 0; j < jmax; ++j) {"
SERIAL_KEY = "kv[e] = e < epl ? to_f32(krow[lane + 32 * e]) : 0.f;"
SERIAL_SCORE = """      float kv[MAX_EPL];
#pragma unroll
      for (int e = 0; e < MAX_EPL; ++e)
        kv[e] = e < epl ? to_f32(krow[lane + 32 * e]) : 0.f;
      if (quantized) {
        const float ks = a.k_scale[scale_base + static_cast<size_t>(s) * a.HKV];
#pragma unroll
        for (int e = 0; e < MAX_EPL; ++e) kv[e] *= ks;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < MAX_EPL; ++e)
            if (e < epl) part = fmaf(qs[g * D + lane + 32 * e], kv[e], part);
"""
# lane l loads elements [l V, l V + V) of the row in one 16-byte load (V =
# 16 / sizeof(KT)); right where D * sizeof(KT) <= 512 (the serve shape)
SERIAL_SCORE_VEC16 = """      constexpr int V = attn::kVec<KT>;
      float kv[V];
      const bool on = lane * V < D;
      if (on) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + lane * V);
        const KT* el = reinterpret_cast<const KT*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) kv[i] = to_f32(el[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kv[i] = 0.f;
      }
      if (quantized) {
        const float ks = a.k_scale[scale_base + static_cast<size_t>(s) * a.HKV];
#pragma unroll
        for (int i = 0; i < V; ++i) kv[i] *= ks;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (on) part = fmaf(qs[g * D + lane * V + i], kv[i], part);
"""
ENTRY = "decode_attention_kernel(Args a) {\n"

# ---- the split kernel -----------------------------------------------------
SPLIT_MARK = "float scale, int n_split, int tile,"   # in its C entry point
SPLIT_ENTRY = "decode_tc_kernel(Args a) {\n"
SPLIT_ON = "const bool on = visible(words, j);"
SPLIT_TC = "constexpr bool tc = sizeof(QT) == 2 && sizeof(KT) == 2;"
# the grid's order: kv-heads fastest, so that blocks in flight together read
# every head of the same slots (whole rows of the cache)
SPLIT_GRID = ("kvh = blockIdx.x, split = blockIdx.y,",
              "dim3(a.HKV, a.n_split, a.B)")
SPLIT_MERGE = ("decode_merge_kernel<QT><<<dim3(a.H / a.HKV, a.HKV, a.B), "
               "NT, 0, stream>>>(a);")
SPLIT_MMA = ("for (int grp = warp; grp * 16 < ns; grp += NW) {",
             "for (int kk = 0; kk < (ns + 15) / 16; ++kk) {")
SPLIT_GRID_OLD = ("split = blockIdx.x, kvh = blockIdx.y,",
                  "dim3(a.n_split, a.HKV, a.B)")
SPLIT_EXP = ("expf(m_old - m_new)", "expf(x[u] - m_new)")


def variants(src: str) -> tuple[str, dict[str, tuple[str, bool]]]:
    """(design, {name: (source, computes the same function)})."""
    def need(*texts):
        for text in texts:
            if text not in src:
                raise SystemExit(f"decode_attention source no longer holds "
                                 f"{text!r}")
    if SERIAL_MARK in src:
        need(SERIAL_PV, SERIAL_KEY, SERIAL_SCORE, ENTRY)
        no_pv = src.replace(SERIAL_PV, "for (int j = 0; j < 0 * jmax; ++j) {")
        const = SERIAL_KEY.replace("to_f32(krow[lane + 32 * e])",
                                   "0.01f * (lane + 32 * e)")
        return "serial", {
            "kernel": (src, True),
            "no_pv_loop": (no_pv, False),
            "constant_keys": (src.replace(SERIAL_KEY, const), False),
            "no_pv_loop_constant_keys": (no_pv.replace(SERIAL_KEY, const),
                                         False),
            "vec16_key_loads": (src.replace(SERIAL_SCORE, SERIAL_SCORE_VEC16),
                                True),
            "empty": (src.replace(ENTRY, ENTRY + "  if (a.B > 0) return;\n"),
                      False),
        }
    if SPLIT_MARK in src:
        need(SPLIT_ON, SPLIT_TC, SPLIT_ENTRY, SPLIT_MERGE, *SPLIT_EXP,
             *SPLIT_GRID, *SPLIT_MMA)
        no_mma = src
        for text in SPLIT_MMA:
            no_mma = no_mma.replace(text, text.replace("< ", "< 0 * "))
        fast, splits_fastest = src, src
        for text in SPLIT_EXP:
            fast = fast.replace(text, "__" + text)
        for text, by in zip(SPLIT_GRID, SPLIT_GRID_OLD):
            splits_fastest = splits_fastest.replace(text, by)
        return "split", {
            "kernel": (src, True),
            # every slot's K and V loaded, visible or not (weights 0 where
            # not; right here because the test caches hold finite values)
            "load_invisible": (src.replace(
                SPLIT_ON, "const bool on = j < ns;"), True),
            "fast_expf": (fast, True),
            "splits_fastest": (splits_fastest, True),
            # timed only: the merge kernel left out, or S and P V left out
            # (loads, softmax, merge)
            "no_merge": (src.replace(SPLIT_MERGE, ";"), False),
            "no_mma": (no_mma, False),
            # bf16 through the CUDA-core kernel (f32 FMAs), not the MMAs
            "cuda_cores": (src.replace(SPLIT_TC, "constexpr bool tc = false;"),
                           True),
            "empty": (src.replace(SPLIT_ENTRY,
                                  SPLIT_ENTRY + "  if (a.B > 0) return;\n"),
                      False),
        }
    raise SystemExit("decode_variants: the source is neither known revision "
                     "of decode_attention.cu")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", type=Path,
                        default=CSRC / "decode_attention.cu")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("decode_variants: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref

    card = cs.nvidia_smi()
    design, found = variants(args.source.read_text())
    # the bf16-query, bf16-cache kernel's registers and spills
    libs = build({name: text for name, (text, _) in found.items()}, OUT,
                 {"kernel"}, ptxas_after(lambda line: "decode_tc_kernel"
                                         in line or "13__nv_bfloat16S" in line))
    found = {name: found[name] for name in libs}
    # the split kernel's entry point takes an lse pointer since it has one
    lse = ["void* lse"] if "void* lse" in args.source.read_text() else []
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib, _ in libs.values():
        tail = [i, i, p, p] + [p] * len(lse) if design == "split" else []
        lib.decode_attention_launch.argtypes = (
            [p] * 7 + [i] * 10 + [ctypes.c_float] + tail + [p])
        lib.decode_attention_launch.restype = ctypes.c_int

    def call(lib, q, k, v, sp, pos, n_split=None):
        b, _, h, d = q.shape
        s, hkv = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        extra = []
        if design == "split":
            n, tile = kdec.split(s, d, k.element_size())
            if n_split is not None:   # the wrapper's tiles for n_split
                most = min(kdec.MAX_TILE, kdec.TILE_BYTES // (2 * d * 2))
                longest = -(-s // n_split)
                n, tile = n_split, -(-longest // -(-longest // most))
            part = kdec.scratch(q, n, hkv)
            extra = [n, tile, *(None if t is None else t.data_ptr()
                                for t in part), *[None] * len(lse)]
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            sp.data_ptr(), out.data_ptr(), 1, 1, b, s, h, hkv, d, pos, -1,
            0, 1.0 / d ** 0.5, *extra,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"decode_variants: launch failed ({err})")
        return out

    gen = torch.Generator(device="cuda").manual_seed(47)
    shapes = {"serve": (39, 96, "prefix")}
    if design == "split":   # the fewest misses a batch; yi-6b's context
        shapes["serve_b20"] = (20, 96, "prefix")
        shapes["yi6b_4096"] = (8, 4096, "full")
    rows = []
    for shape, (b, s, layout) in shapes.items():
        h, hkv, d = 32, 4, 128
        q, k, v = cs._attn_inputs(torch, gen, ((b, 1, h, d), (b, s, hkv, d),
                                               (b, s, hkv, d)),
                                  torch.bfloat16)
        sp, pos = cs._decode_slots(torch, s, layout)
        want = ref.decode_attention_ref(q, k, v, sp, pos)
        fns, errs = {}, {}
        for name, (lib, _) in libs.items():
            fns[name] = (lambda lib=lib: call(lib, q, k, v, sp, pos))
            if found[name][1]:
                errs[name] = cs._attn_err(torch, fns[name](), want, "bf16",
                                          f"{name} {shape}")
        if design == "split":
            lib = libs["kernel"][0]
            auto = kdec.split(s, d, 2)[0]
            for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 128):
                if n != auto and (n <= s // kdec.MIN_SLOTS or n == 1):
                    name = f"n_split={n}"
                    fns[name] = (lambda n=n: call(lib, q, k, v, sp, pos, n))
                    errs[name] = cs._attn_err(torch, fns[name](), want,
                                              "bf16", f"{name} {shape}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = ((sp >= 0) & (sp <= pos))[None, None, None, :]
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        times = turns(fns, 200)
        for name, runs in times.items():
            row = {"design": design, "shape": shape, "B": b, "S": s,
                   "visible": int(((sp >= 0) & (sp <= pos)).sum()),
                   "variant": name, "graph_ms": min(runs), "runs_ms": runs,
                   "max_abs_err": errs.get(name),
                   "ptxas": libs[name][1] if name in libs else None,
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(card)


if __name__ == "__main__":
    main()
