#!/usr/bin/env python3
"""A/B of the IVF candidate top-k (PERF.md §6 row 7) against variants of
itself and of the per-query kernel before it, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 ivf_variants.py [--parent FILE.cu] [--out FILE.jsonl]

Each variant is ``src/repro_torch/kernels/csrc/ivf_topk.cu`` (the
bucket-major kernel) or, with the ``parent`` prefix, ``--parent``: the
per-query kernel it replaced, one query row a block and a warp a candidate
row (``git show 1536516:src/repro_torch/kernels/csrc/ivf_topk.cu``), with
one choice changed by a text edit, built with ``nvcc`` into
``build/ivf_variants/``, one process each, all at once. Variants:

  new             this tree's kernel, with the probe's grouping and without
  new_no_merge    the second launch left out (timed only)
  new_z1, new_z22, new_z84
                  one block a bucket, up to 2 x 2 or 8 x 4 (tiles x slices;
                  groups of one: 1 or 2 blocks, 2 for z84), not up to 4 x 3
  new_3_blocks    pass 1 without its 128-register cap (three blocks an SM)
  new_empty_merge the merge kernel launched but returning at once (timed only)
  new_no_tasks, new_no_stage, new_scans_only, new_no_cand
                  pass 1 alone without its warp tasks, without staging the
                  rows or with neither; both passes without the tasks' cand
                  loads (timed only)
  parent          the per-query kernel as it was
  parent_no_merge its merge launch left out (timed only)
  parent_rows_in_flight
                  a warp's rows loaded 8 at a time, all in flight, before
                  their dot products (16-byte rows of at most 3 loads a lane)
  parent_ids_only the id scan and compaction alone: no row scored, no merge
                  (timed only)

Those that compute the same function are held against the plain version
(``kernels/ref.py``, ``chip_smoke._compare``). All are timed from CUDA
graphs in turns at the IVF serve path's shape (the first served batch's
candidate matrix after the refit: B=128, 16 probes of 1,024 positions,
N=16,384, d=384, k=4) and with every one of the 16,384 ids visible and
random (``all_visible``, ungrouped), for f32 and int8 keys. Prints one JSON
line per measurement (also written to ``--out``, by default
``build/ivf_variants/ivf_variants.jsonl``) and, last, the card's name and
power limit. The script exits if a source no longer holds a text it edits.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

from variant_harness import CSRC, ROOT, build, turns

OUT = ROOT / "build" / "ivf_variants"

# ---- this tree's bucket-major kernel --------------------------------------
N_MERGE = ("  ivf_topk_merge<<<(a.B + MW - 1) / MW, MW * 32, 0, stream>>>(a, "
           "out_s, out_i);\n")
N_ZM = "  a.ZM = min((a.cap + a.MT - 1) / a.MT, grouped ? 4 : 2);"
N_ZS = "  a.ZS = grouped ? min((a.B * a.P + PS - 1) / PS, 3) : 1;"

N_COPY = ("          cp_async16(rows + r * a.stride + 16 * gq,\n"
          "                     kbytes + (size_t)tile_id[r] * row_bytes + 16 * gq);\n")
N_TASKS = "        for (int grp = sub; grp < NG; grp += S) {"
N_MERGE_BODY = ("  const int b = blockIdx.x * MW + (threadIdx.x >> 5);\n"
                "  if (b >= a.B) return;")
N_BOUNDS = "__launch_bounds__(NT, 4)\nivf_topk_buckets("
N_CAND = "            const int id = __ldg(a.cand + (size_t)(f / a.P) * a.M + pos);"

# ---- the per-query kernel (--parent) --------------------------------------
P_MERGE = "  if (err != cudaSuccess) return err;\n  ivf_topk_merge<<<"
P_MINE = "  const int mine = (total - warp + WARPS - 1) / WARPS;"
P_ROWS = """    for (int j = 0; j < n; ++j) {
      const int e = warp + WARPS * (base + j);
      const float v = row_dot<KT, VEC>(qs, keys + (size_t)vis_id[e] * d, d, lane);
      if (lane == j) {
        s = v;
        pos = vis_pos[e];
      }
    }
"""
# the same sums (row_dot's order), the loads of 8 rows issued before any
# of their dot products
P_ROWS_IN_FLIGHT = """    if constexpr (VEC) {
      constexpr int E = Vec<KT>::N;
      const int groups = d / E;
      for (int j0 = 0; j0 < n; j0 += 8) {
        uint4 buf[8][3];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int e = warp + WARPS * (base + min(j0 + jj, n - 1));
          const uint4* r = reinterpret_cast<const uint4*>(keys + (size_t)vis_id[e] * d);
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int v = lane + 32 * t;
            buf[jj][t] = v < groups ? __ldg(r + v) : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int v = lane + 32 * t;
            if (v < groups) {
              float kf[E];
              Vec<KT>::unpack(buf[jj][t], kf);
              const float4* q4 = reinterpret_cast<const float4*>(qs + v * E);
              float part = 0.0f;
#pragma unroll
              for (int x = 0; x < E / 4; ++x) {
                const float4 qq = q4[x];
                part = fmaf(qq.x, kf[4 * x], part);
                part = fmaf(qq.y, kf[4 * x + 1], part);
                part = fmaf(qq.z, kf[4 * x + 2], part);
                part = fmaf(qq.w, kf[4 * x + 3], part);
              }
              acc += part;
            }
          }
          const float v = warp_sum(acc);
          if (lane == j0 + jj) {
            s = v;
            pos = vis_pos[warp + WARPS * (base + j0 + jj)];
          }
        }
      }
    } else {
""" + P_ROWS + "    }\n"


def _need(src: str, name: str, *texts: str) -> None:
    for text in texts:
        if text not in src:
            raise SystemExit(f"ivf_variants: {name} no longer holds "
                             f"{text!r}")


def variants(src: str, parent: str | None
             ) -> dict[str, tuple[str, str, bool]]:
    """{name: (source, design, computes the same function)}."""
    _need(src, "ivf_topk.cu", N_MERGE, N_ZM, N_ZS, N_COPY, N_TASKS, N_CAND,
          N_MERGE_BODY, N_BOUNDS)
    # the phases without the merge, whose input they leave unwritten
    alone = src.replace(N_MERGE, "  return err;\n")
    no_tasks = alone.replace(N_TASKS, N_TASKS.replace("grp < NG", "grp < 0"))
    no_stage = alone.replace(N_COPY, "")
    out = {
        "new": (src, "new", True),
        "new_no_merge": (src.replace(N_MERGE, "  return err;\n"), "new",
                         False),
        "new_z1": (src.replace(N_ZM, "  a.ZM = 1;").replace(
            N_ZS, "  a.ZS = 1;"), "new", True),
        "new_z22": (src.replace(N_ZM, N_ZM.replace("4 : 2", "2 : 2")).replace(
            N_ZS, N_ZS.replace("3) : 1", "2) : 1")), "new", True),
        "new_z84": (src.replace(N_ZM, N_ZM.replace("4 : 2", "8 : 2")).replace(
            N_ZS, N_ZS.replace("3) : 1", "4) : 1")), "new", True),
        # pass 1 alone: the scans and the staging without the warp tasks,
        # the tasks over rows never staged, the scans alone; and the whole
        # without the tasks' cand loads (every staged member visible)
        "new_no_tasks": (no_tasks, "new", False),
        "new_no_stage": (no_stage, "new", False),
        "new_scans_only": (no_tasks.replace(N_COPY, ""), "new", False),
        # no register cap: 159-168 registers, three blocks an SM
        "new_3_blocks": (src.replace(N_BOUNDS, N_BOUNDS.replace(
            "(NT, 4)", "(NT)")), "new", True),
        # the merge launched, its work left out: its launch and wait alone
        "new_empty_merge": (src.replace(N_MERGE_BODY, N_MERGE_BODY.replace(
            "if (b >= a.B) return;", "if (b >= 0) return;")), "new", False),
        "new_no_cand": (src.replace(N_CAND, "            const int id = 0;"),
                        "new", False),
    }
    if parent is not None:
        _need(parent, "--parent", P_MERGE, P_MINE, P_ROWS)
        no_merge = parent.replace(P_MERGE, "  return err;\n  ivf_topk_merge<<<")
        out.update({
            "parent": (parent, "parent", True),
            "parent_no_merge": (no_merge, "parent", False),
            "parent_rows_in_flight": (parent.replace(P_ROWS, P_ROWS_IN_FLIGHT),
                                      "parent", True),
            "parent_ids_only": (no_merge.replace(
                P_MINE, "  const int mine = 0 * total;"), "parent", False),
        })
    return out


def ptxas_lines(log: str) -> list:
    """Registers, stack, spills and shared memory of each kernel entry, from
    nvcc's -Xptxas -v."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--out", type=Path,
                        default=OUT / "ivf_variants.jsonl")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ivf_variants: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.cosine_topk import DTYPE_CODE

    card = cs.nvidia_smi()
    found = variants((CSRC / "ivf_topk.cu").read_text(),
                     None if args.parent is None else args.parent.read_text())
    libs = build({name: text for name, (text, _, _) in found.items()}, OUT,
                 {"new", "parent"}, ptxas_lines)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, _) in libs.items():
        lib.ivf_topk_launch.argtypes = (
            [p, p, i, p, p, p] + [i] * 8 + [p] * 4
            if found[name][1] == "new" else [p, p, i, p] + [i] * 6 + [p] * 5)
        if found[name][1] == "new":
            lib.ivf_topk_scratch_bytes.argtypes = [i] * 10
            lib.ivf_topk_scratch_bytes.restype = ctypes.c_longlong
    args.out.parent.mkdir(parents=True, exist_ok=True)
    sink = args.out.open("w")

    def emit(row: dict) -> None:
        row["card"] = card
        print(json.dumps(row), flush=True)
        sink.write(json.dumps(row) + "\n")

    for name, (lib, ptxas) in libs.items():
        emit({"variant": name, "ptxas": ptxas})

    def call(name, q, keys, cand, k, probe=None, buckets=None):
        lib = libs[name][0]
        b, d = q.shape
        n, m = keys.shape[0], cand.shape[1]
        out_s = torch.empty((b, k), dtype=torch.float32, device="cuda")
        out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        head = (q.data_ptr(), keys.data_ptr(), DTYPE_CODE[keys.dtype],
                cand.data_ptr())
        if found[name][1] == "parent":
            chunks = -(-m // 2048)
            part = [torch.empty((b, chunks * 8, k), dtype=dt, device="cuda")
                    for dt in (torch.float32, torch.int32)]
            err = lib.ivf_topk_launch(*head, b, n, m, d, k, chunks,
                                      *(t.data_ptr() for t in part),
                                      out_s.data_ptr(), out_i.data_ptr(),
                                      stream)
        else:
            pp, (c, cap) = ((probe.shape[1], buckets.shape)
                            if probe is not None else (0, (0, 0)))
            scratch = torch.empty(lib.ivf_topk_scratch_bytes(
                DTYPE_CODE[keys.dtype], probe is not None, b, n, m, d, k, pp,
                c, cap), dtype=torch.uint8, device="cuda")
            err = lib.ivf_topk_launch(
                *head, None if probe is None else probe.data_ptr(),
                None if buckets is None else buckets.data_ptr(), b, n, m, d,
                k, pp, c, cap, scratch.data_ptr(), out_s.data_ptr(),
                out_i.data_ptr(), stream)
        if err != 0:
            raise SystemExit(f"ivf_variants: {name} launch failed ({err})")
        return out_s, out_i

    _, q, slab, cand, probe, buckets = cs._ivf_serve_candidates(torch)
    slab = slab.float()
    gen = torch.Generator(device="cuda").manual_seed(17)
    every = torch.randint(0, slab.shape[0], cand.shape, generator=gen,
                          device="cuda", dtype=torch.int32)
    k = 4
    for shape, ids in (("serve", cand), ("all_visible", every)):
        vis = ids >= 0
        stats = {"visible_pairs": int(vis.sum()),
                 "distinct_rows": int(torch.unique(ids[vis]).numel())}
        for dtype in ("f32", "int8"):
            keys = slab if dtype == "f32" else torch.clamp(
                torch.round(slab * 127.0), -127, 127).to(torch.int8)
            rs1, ri1 = ref.ivf_topk_ref(q, keys, ids, k + 1)
            fns, errs = {}, {}
            for name in libs:
                forms = {"": {}}
                if found[name][1] == "new":
                    forms = ({"_ungrouped": {}} if shape == "all_visible"
                             else {"": dict(probe=probe, buckets=buckets),
                                   "_ungrouped": {}})
                for suffix, kw in forms.items():
                    fns[name + suffix] = (lambda name=name, kw=kw:
                                          call(name, q, keys, ids, k, **kw))
                    if found[name][2]:
                        ks, ki = fns[name + suffix]()
                        errs[name + suffix] = cs._compare(
                            torch, ks, ki, rs1, ri1, k, cs.SCORE_TOL[dtype],
                            f"{name}{suffix} {dtype} {shape}", {})
            times = turns(fns, 100 if shape == "serve" else 10)
            for name, runs in times.items():
                emit({"shape": shape, "B": q.shape[0], "M": ids.shape[1],
                      "N": slab.shape[0], "d": q.shape[1], "k": k,
                      "key_dtype": dtype, "variant": name,
                      "graph_ms": min(runs), "runs_ms": runs,
                      "max_abs_err": errs.get(name), **stats})
    sink.close()
    print(card)


if __name__ == "__main__":
    main()
