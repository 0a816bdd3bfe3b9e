#!/usr/bin/env python3
"""A/B of the bf16 flash-attention kernel against variants of itself, on
one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 flash_variants.py

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with one
design choice undone by a text edit (the exponential, the normalization,
the visibility test, the blocks an SM), built with ``nvcc`` into
``build/flash_variants/``, held against the plain version at the serve
shape and on four other shapes, and timed from CUDA graphs at the serve
shape (B=39, L=64 causal, H=32, HKV=4, D=128) in turns with
``scaled_dot_product_attention``. Prints one JSON line per variant and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import sys

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
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ref

    card = cs.nvidia_smi()
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
    print(card)


if __name__ == "__main__":
    main()
