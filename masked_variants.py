#!/usr/bin/env python3
"""A/B of the dense-mask cosine top-k (PERF.md §6 rows 5 and 6) against
the kernel before its redesign, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with an H100 and the CUDA
toolkit:

    python3 masked_variants.py --parent FILE.cu [--out FILE.jsonl]

``--parent`` is the source before the redesign, which scored every (row,
key) pair of a 64-row tile whatever the mask said
(``git show 873c33a:src/repro_torch/kernels/csrc/cosine_topk.cu``). Both it
and this tree's ``src/repro_torch/kernels/csrc/cosine_topk.cu`` are built
with ``nvcc`` into ``build/masked_variants/``, one process each, all at
once, the parent also with the dense form given the interval form's 32-row
tiles by a text edit (``parent_dense32``). At the timing shape of rows 3-6
(B=128, N=65,536, d=384, k=4; four regions of 16,384 slots, rows given to
them round robin, 90% of the slots valid) it times, from CUDA graphs in
turns, for f32 keys, int8 keys (1/127) and int8 keys with per-row scales:

  parent_dense        (a) the parent's dense kernel with the region mask
  parent_dense_all    (b) the same with every slot visible
  parent_visible      (c) the visible work alone on the parent's loop: each
                      region's 32 rows over its 16,384-key slice, four
                      launches of ``parent_dense32``
  parent_interval     (d) the interval form at the same visibility (the row
                      order on the card, then the launch), at the parent's
                      plan: one block an SM
  parent_unstructured the parent's dense kernel where each row sees an
                      independent random 80% of N
  new                 this tree's dense form as its wrapper launches it:
                      pass 0, the sort of its keys, pass 1 and the merge,
                      the plan read back once outside the graph
  new_all, new_unstructured
                      the same with every slot visible, and with the
                      unstructured mask
  new_unsorted        the rows in their given order (round robin), not
                      grouped: every tile's union is all of N
  new_mask_first      a tile's mask bytes loaded before its products, not
                      after them
  new_skip            the shared form's never-taken skip of a tile also in
                      the dense form's loop (in the blocks-an-SM sweep below:
                      ``skip_sm*``)
  new_no_union        no union: chunk c takes the c-th run of all of N's
                      tiles, as the parent did (in the sweep with every slot
                      visible: ``no_union_sm*``)
  new_shared_rows     the query row of each load read through shared
                      memory at every load, not held in registers, in both
                      grouped forms (in the sweep: ``shared_rows_sm*``;
                      the interval form: ``shared_rows_interval``)
  new_plan            pass 0 and the ranking of its keys alone (timed only)
  library_sort        the same, then ``torch.sort`` of the keys (timed only)
  new_interval        this tree's interval form (rows 3 and 4), also
                      chunked for 1 and 4 blocks an SM
                      (``new_interval_sm1``, ``new_interval_sm4``)
  new_probe, parent_probe, new_shared, parent_shared
                      the shared-mask form at the IVF probe's shape (B=128
                      over 128 centroids, k=16: the 4-row FMA tiles) and at
                      the main path's (N=16,384: the tensor-core form)

and, for int8 keys with per-row scales only, ``parent_dense``, ``new`` and
the interval rows at N=1,048,576 (four regions of 262,144). Then, for f32
and int8 keys, the plan's blocks an SM: this tree's dense form with 1, 2
and 4 blocks an SM (``sm1``, ``sm2``, ``sm4``) and its interval form the
same (``interval_sm*``, ``shared_rows_interval``) beside the parent's
(``parent_dense``, ``parent_interval``), with rows round robin over
4 and 8 regions (32- and 16-row tiles), every row in the first of 4
regions (64-row tiles over a quarter of N) and every slot visible (64-row
tiles over N). Each result that computes the whole
function is held against the plain version (``kernels/ref.py``,
``chip_smoke._compare``), and ``new`` against ``new_interval`` bit for bit.
Prints one JSON line per measurement (also written to ``--out``, by
default ``build/masked_variants/masked_variants.jsonl``) and, last, the
card's name and power limit. The script exits if the parent no longer holds
a text it edits.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

from variant_harness import CSRC, ROOT, build, turns

OUT = ROOT / "build" / "masked_variants"
B, D, K, REGIONS = 128, 384, 4, 4

# ---- the dense form before the redesign (--parent) -------------------------
P_LAUNCH = ("    if constexpr (MS == INTERVAL_MASK) {\n"
            "      if (a.block_q == BQ_32)")
P_SPLIT = "(interval && (a.block_q == BQ_32 || a.block_q == BQ_16))"

# ---- this tree's dense form --------------------------------------------------
N_FETCH0 = "    if constexpr (PREFETCH) fetch(0);\n"
N_VIS = "          vis = vis && is_row(gr) && mask[(size_t)gr * N + gn];"
N_SKIP = ("    if constexpr (MS == SHARED_MASK) {\n"
          "      if (n0 + BN <= blk_lo || n0 >= blk_hi) continue;")
N_UNION = "    // the tiles some row of the block sees"
N_QROW = "          const int gr = q_rows[p], gc = c0 + c;\n"
N_LISTED = "    // positions v0 = 0, BN, ... of the loop below are the listed tiles\n"
# no union: chunk c lists the c-th run of all of N's tiles, as the parent
# chunked N (visibility from the mask bytes alone)
N_NO_UNION = """    const int T = (N + BN - 1) / BN, per = (T + chunks - 1) / chunks;
    const int lo = min(T, chunk * per), hi = min(T, lo + per);
    for (int t = tid; t < hi - lo; t += NT) tile_list[t] = lo + t;
    __syncthreads();
"""
# the never-taken skip of the shared form, over the loop's positions, in the
# dense form's loop too
N_SKIP_DENSE = ("    if constexpr (MS != INTERVAL_MASK) {\n"
                "      if (v0 + BN <= blk_lo || v0 >= blk_hi) continue;")
# the tile's mask bytes loaded into registers before the products
N_MASK_FIRST = N_FETCH0 + """    bool pre[TQ][TN];
    if constexpr (MS == DENSE_MASK) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gr = qrow(ty + TY * i), gn = n0 + tx + TX * j;
          pre[i][j] = gn < key_end && is_row(gr) && mask[(size_t)gr * N + gn];
        }
    }
"""


def _need(src: str, name: str, *texts: str) -> None:
    for text in texts:
        if text not in src:
            raise SystemExit(f"masked_variants: {name} no longer holds "
                             f"{text!r}")


def variants(src: str, parent: str) -> dict[str, str]:
    """{name: source}."""
    _need(src, "cosine_topk.cu", N_FETCH0, N_VIS, N_SKIP, N_UNION, N_LISTED,
          N_QROW)
    cut = src.index(N_UNION), src.index(N_LISTED)
    _need(parent, "--parent", P_LAUNCH, P_SPLIT)
    dense32 = parent.replace(
        P_LAUNCH, P_LAUNCH.replace("MS == INTERVAL_MASK",
                                   "MS != SHARED_MASK")).replace(
        P_SPLIT, P_SPLIT.replace("interval &&", "MS != SHARED_MASK &&"))
    return {"new": src,
            "new_mask_first": src.replace(N_FETCH0, N_MASK_FIRST).replace(
                N_VIS, "          vis = pre[i][j];"),
            "new_skip": src.replace(N_SKIP, N_SKIP_DENSE),
            "new_no_union": src[:cut[0]] + N_NO_UNION + src[cut[1]:],
            # the grouped forms' query rows read through shared memory at
            # every load of a slice, not held in registers
            "new_shared_rows": src.replace(
                N_QROW, "          const int gr = qrow(r), gc = c0 + c;\n"),
            "parent": parent, "parent_dense32": dense32}


def ptxas_lines(log: str) -> list:
    """Registers, spills and shared memory of the interval and dense-mask
    pass 1 and of pass 0."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and (re.search(r"cosine_topk_partialI[^L]*Li[12]E", entry)
                        or "summary" in entry) and (
                "Used" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def parent_split(b: int, n: int, sms: int, chunking) -> tuple[int, int, int]:
    """The parent's plan of the dense form: 64-row tiles, or 4-row ones
    where 64-row tiles over one 128-key tile each give fewer blocks than
    SMs; about four blocks an SM."""
    block_q = 64 if -(-b // 64) * -(-n // 128) >= sms else 4
    return chunking(b, n, sms, block_q, 4)


def parent_interval_split(b: int, span: int, sms: int, plan, chunking
                          ) -> tuple[int, int, int]:
    """The parent's plan of the interval form: this tree's tile height
    (``plan``'s), chunked over ``span`` for one block an SM."""
    return chunking(b, span, sms, plan[2], 1)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--out", type=Path,
                        default=OUT / "masked_variants.jsonl")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("masked_variants: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.similarity import interval_visibility
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref

    card = cs.nvidia_smi()
    found = variants((CSRC / "cosine_topk.cu").read_text(),
                     args.parent.read_text())
    libs = build(found, OUT, set(found), ptxas_lines)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 7 + [p] * 5
    for name, (lib, _) in libs.items():
        # order, tile bitmaps
        dense = [p, p] if name.startswith("new") else []
        lib.cosine_topk_masked_launch.argtypes = [p, p, i, p] + dense + tail
        lib.quant_cosine_topk_masked_launch.argtypes = [p] * 4 + dense + tail
        lib.cosine_topk_interval_launch.argtypes = [p, p, i, p, p, p, p] + tail
        lib.quant_cosine_topk_interval_launch.argtypes = [p] * 7 + tail
        lib.cosine_topk_launch.argtypes = [p, p, i, p] + tail
        lib.quant_cosine_topk_launch.argtypes = [p] * 4 + tail
    new = libs["new"][0]
    new.cosine_topk_tile_summary_launch.argtypes = [p, i, i] + [p] * 5
    args.out.parent.mkdir(parents=True, exist_ok=True)
    sink = args.out.open("w")

    def emit(row: dict) -> None:
        row["card"] = card
        print(json.dumps(row), flush=True)
        sink.write(json.dumps(row) + "\n")

    for name, (_, ptxas) in libs.items():
        emit({"variant": name, "ptxas": ptxas})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def call(lib, entry, q, slab, masks, plan, k=K):
        """One launch of ``entry`` (``masked``, ``interval`` or the shared
        form ``""``) of ``lib`` on ``slab`` = (keys,) or (int8 keys, scales)
        with the plan (keys per chunk, chunks, block_q)."""
        b, d = q.shape
        n = slab[0].shape[0]
        per_chunk, chunks, block_q = plan
        part = [torch.empty((b, chunks, k), dtype=dt, device="cuda")
                if chunks > 1 else None
                for dt in (torch.float32, torch.int32)]
        out_s = torch.empty((b, k), dtype=torch.float32, device="cuda")
        out_i = torch.empty((b, k), dtype=torch.int32, device="cuda")
        quant = len(slab) == 2
        fn = getattr(lib, f"{'quant_' if quant else ''}cosine_topk"
                          f"{'_' + entry if entry else ''}_launch")
        head = ((q.data_ptr(), slab[0].data_ptr(), slab[1].data_ptr())
                if quant else (q.data_ptr(), slab[0].data_ptr(),
                               kmod.DTYPE_CODE[slab[0].dtype]))
        err = fn(*head, *(m.data_ptr() for m in masks), b, n, d, k,
                 per_chunk, chunks, block_q,
                 *(None if t is None else t.data_ptr() for t in part),
                 out_s.data_ptr(), out_i.data_ptr(), stream())
        if err != 0:
            raise SystemExit(f"masked_variants: {entry} launch failed ({err})")
        return out_s, out_i

    def summary(mask):
        b, n = mask.shape
        bits = torch.empty((b, -(-(-(-n // 128)) // 32)), dtype=torch.int32,
                           device="cuda")
        key = torch.empty(b, dtype=torch.int64, device="cuda")
        tiles = torch.empty(b, dtype=torch.int32, device="cuda")
        order = torch.empty(b, dtype=torch.int32, device="cuda")
        err = new.cosine_topk_tile_summary_launch(
            mask.data_ptr(), b, n, bits.data_ptr(), key.data_ptr(),
            tiles.data_ptr(), order.data_ptr(), stream())
        if err != 0:
            raise SystemExit(f"masked_variants: pass 0 failed ({err})")
        return bits, key, tiles, order

    def new_dense(q, slab, mask, plan, order=None, lib=new):
        """What the wrapper launches: pass 0 and the ranking of its keys,
        then pass 1 (the plan read back beforehand); ``order`` fixes the row
        order."""
        bits, _, _, ranked = summary(mask)
        return call(lib, "masked", q, slab,
                    (mask, ranked if order is None else order, bits), plan)

    def new_plan(mask, per_sm=None):
        """This tree's plan of ``mask`` (``split``), or the same tile
        height chunked for ``per_sm`` blocks an SM."""
        bits, key, tiles, order = summary(mask)
        assert torch.equal(order.long(), torch.sort(key, stable=True)[1])
        skey = key[order.long()]
        first = torch.ones_like(skey, dtype=torch.bool)
        first[1:] = skey[1:] != skey[:-1]
        groups, most = torch.stack([(first & (skey != ref.EMPTY_KEY)).sum(),
                                    tiles.max().long()]).tolist()
        for got, want in zip((bits, key, tiles), ref.tile_summary_ref(mask)):
            assert torch.equal(got, want)
        b, n = mask.shape
        plan = kmod.split(b, n, sms, groups, most * 128, dense=True)
        if per_sm is None:
            return plan
        return kmod.chunking(b, most * 128, sms, plan[2], per_sm)

    def check(name, got, q, slab, mask, dtype):
        prefix = "quant_" if len(slab) == 2 else ""
        rs1, ri1 = getattr(ref, f"{prefix}cosine_topk_ref")(q, *slab, mask,
                                                           K + 1)
        ks, ki = got
        return cs._compare(torch, ks, ki, rs1, ri1, K, cs.SCORE_TOL[dtype],
                           f"{name} {dtype}", {})

    for n, dtype in ((65536, "f32"), (65536, "int8"), (65536, "quant"),
                     (1048576, "quant")):
        gen = torch.Generator(device="cuda").manual_seed(11)
        slab, _, _ = cs._timing_slab(torch, gen, n, D, dtype)
        q = torch.randn((B, D), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9
        size = n // REGIONS
        region = torch.arange(B, device="cuda") % REGIONS
        starts = (region * size).to(torch.int32)
        sizes = torch.full((B,), size, dtype=torch.int32, device="cuda")
        mask = interval_visibility(valid, starts, sizes)
        scales = slab[1] if len(slab) == 2 else None
        _, groups, span = kmod.interval_plan(q, slab[0], valid, starts, sizes,
                                             K, scales)
        interval_plan = kmod.split(B, n, sms, groups, span)
        dense_plan = parent_split(B, n, sms, kmod.chunking)
        order = lambda: kmod.interval_order(starts, sizes)  # noqa: E731
        plan = new_plan(mask)
        fns = {
            "parent_dense": lambda: call(libs["parent"][0], "masked", q, slab,
                                         (mask,), dense_plan),
            "new": lambda: new_dense(q, slab, mask, plan),
            "new_mask_first": lambda: new_dense(
                q, slab, mask, plan, lib=libs["new_mask_first"][0]),
        }
        plans = {"parent_dense": dense_plan, "new": plan,
                 "new_mask_first": plan}
        masks = {"parent_dense": mask, "new": mask, "new_mask_first": mask}
        # the interval form (rows 3 and 4) at the same visibility: the
        # parent's, this tree's, this tree's chunked for 1 and 4 blocks an
        # SM, and this tree's with its query rows read through shared memory
        interval_libs = {"parent_interval": (libs["parent"][0],
                                             parent_interval_split(
                                                 B, span, sms, interval_plan,
                                                 kmod.chunking)),
                         "new_interval": (new, interval_plan),
                         "shared_rows_interval": (libs["new_shared_rows"][0],
                                                  interval_plan)}
        for per_sm in (1, 4):
            interval_libs[f"new_interval_sm{per_sm}"] = (new, kmod.chunking(
                B, span, sms, interval_plan[2], per_sm))
        for name, (lib, iplan) in interval_libs.items():
            fns[name] = (lambda lib=lib, iplan=iplan: call(
                lib, "interval", q, slab, (valid, starts, sizes, order()),
                iplan))
            plans[name], masks[name] = iplan, mask
        if n == 65536:
            every = torch.ones((B, n), dtype=torch.bool, device="cuda")
            loose = torch.rand((B, n), generator=gen, device="cuda") < 0.8
            all_plan, loose_plan = new_plan(every), new_plan(loose)
            identity = torch.arange(B, dtype=torch.int32, device="cuda")
            # (c): region r's rows and slots, contiguous
            parts = []
            for r in range(REGIONS):
                rows = torch.nonzero(region == r).flatten()
                sl = slice(r * size, (r + 1) * size)
                parts.append((q[rows].contiguous(),
                              tuple(t[sl] for t in slab),
                              mask[rows][:, sl].contiguous()))
            part_plan = kmod.chunking(B // REGIONS, size, sms, 32, 1)
            gen_p = torch.Generator(device="cuda").manual_seed(5)
            probe_keys = cs._make_keys(torch, gen_p, 128, D, "f32")
            probe_valid = torch.ones(128, dtype=torch.bool, device="cuda")
            probe_plan = kmod.split(B, 128, sms, shared=True)
            shared_plan = kmod.split(B, 16384, sms, shared=True)
            shared_slab = tuple(t[:16384] for t in slab)
            for side in ("parent", "new"):
                lib = libs[side][0]
                fns[f"{side}_probe"] = (
                    lambda lib=lib: call(lib, "", q, (probe_keys,),
                                         (probe_valid,), probe_plan, k=16))
                fns[f"{side}_shared"] = (
                    lambda lib=lib: call(lib, "", q, shared_slab,
                                         (valid[:16384],), shared_plan))
            fns.update({
                "parent_dense_all": lambda: call(
                    libs["parent"][0], "masked", q, slab, (every,),
                    dense_plan),
                "parent_visible": lambda: [
                    call(libs["parent_dense32"][0], "masked", qq, ss, (mm,),
                         part_plan) for qq, ss, mm in parts],
                "parent_unstructured": lambda: call(
                    libs["parent"][0], "masked", q, slab, (loose,),
                    dense_plan),
                "new_all": lambda: new_dense(q, slab, every, all_plan),
                "new_unstructured": lambda: new_dense(q, slab, loose,
                                                      loose_plan),
                "new_unsorted": lambda: new_dense(q, slab, mask, plan,
                                                  identity),
                "new_plan": lambda: summary(mask),
                "library_sort": lambda: torch.sort(summary(mask)[1],
                                                   stable=True),
            })
            plans.update({
                "parent_dense_all": dense_plan, "parent_visible": part_plan,
                "parent_unstructured": dense_plan, "new_all": all_plan,
                "new_unstructured": loose_plan, "new_unsorted": plan,
                "parent_probe": probe_plan,
                "new_probe": probe_plan, "parent_shared": shared_plan,
                "new_shared": shared_plan})
            masks.update({"parent_dense_all": every, "new_all": every,
                          "parent_unstructured": loose,
                          "new_unstructured": loose, "new_unsorted": mask})
        errs = {name: check(name, fns[name](), q, slab, m, dtype)
                for name, m in masks.items()}
        if n == 65536:
            for r, (qq, ss, mm) in enumerate(parts):
                got = call(libs["parent_dense32"][0], "masked", qq, ss, (mm,),
                           part_plan)
                errs["parent_visible"] = max(
                    errs.get("parent_visible", 0.0),
                    check(f"parent_visible {r}", got, qq, ss, mm, dtype))
            a, b = fns["new"](), fns["new_interval"]()
            if not (torch.equal(a[0].view(torch.int32),
                                b[0].view(torch.int32))
                    and torch.equal(a[1], b[1])):
                raise SystemExit(f"masked_variants: dense and interval "
                                 f"differ ({dtype})")
        for name, runs in turns(fns, 50 if n == 65536 else 5).items():
            emit({"B": B, "N": n, "d": D, "k": K, "regions": REGIONS,
                  "key_dtype": dtype, "variant": name,
                  "graph_ms": min(runs), "runs_ms": runs,
                  "split": plans.get(name), "max_abs_err": errs.get(name)})

    # the plan's blocks an SM, by tile height
    n = 65536
    for dtype in ("f32", "int8"):
        gen = torch.Generator(device="cuda").manual_seed(13)
        slab, _, _ = cs._timing_slab(torch, gen, n, D, dtype)
        q = torch.randn((B, D), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9
        rows = torch.arange(B, device="cuda")
        for layout, regions, region in (("four", 4, rows % 4),
                                         ("eight", 8, rows % 8),
                                         ("one", 4, rows * 0),
                                         ("all", 1, rows * 0)):
            size = n // regions
            vis = valid if layout != "all" else valid | True
            starts = (region * size).to(torch.int32)
            sizes = torch.full((B,), size, dtype=torch.int32, device="cuda")
            mask = interval_visibility(vis, starts, sizes)
            fns = {"parent_dense": lambda mask=mask: call(
                libs["parent"][0], "masked", q, slab, (mask,),
                parent_split(B, n, sms, kmod.chunking))}
            plans = {"parent_dense": parent_split(B, n, sms, kmod.chunking)}
            # the interval form at the same visibility: the parent's plan
            # (one block an SM), and this tree's code at 1, 2 and 4 blocks
            # an SM and, at its plan, with its query rows read through
            # shared memory
            _, groups, span = kmod.interval_plan(q, slab[0], vis, starts,
                                                 sizes, K)
            iplan = kmod.split(B, n, sms, groups, span)
            irows = (vis, starts, sizes, kmod.interval_order(starts, sizes))
            interval_libs = {"parent_interval": (
                libs["parent"][0],
                parent_interval_split(B, span, sms, iplan, kmod.chunking)),
                             "shared_rows_interval": (
                                 libs["new_shared_rows"][0], iplan)}
            for per_sm in (1, 2, 4):
                interval_libs[f"interval_sm{per_sm}"] = (new, kmod.chunking(
                    B, span, sms, iplan[2], per_sm))
            for name, (lib, pl) in interval_libs.items():
                plans[name] = pl
                fns[name] = (lambda lib=lib, pl=pl, irows=irows: call(
                    lib, "interval", q, slab, irows, pl))
            for per_sm in (1, 2, 4):
                plans[f"sm{per_sm}"] = plan = new_plan(mask, per_sm)
                fns[f"sm{per_sm}"] = (lambda mask=mask, plan=plan:
                                      new_dense(q, slab, mask, plan))
                plans[f"skip_sm{per_sm}"] = plan
                fns[f"skip_sm{per_sm}"] = (
                    lambda mask=mask, plan=plan: new_dense(
                        q, slab, mask, plan, lib=libs["new_skip"][0]))
                plans[f"shared_rows_sm{per_sm}"] = plan
                fns[f"shared_rows_sm{per_sm}"] = (
                    lambda mask=mask, plan=plan: new_dense(
                        q, slab, mask, plan, lib=libs["new_shared_rows"][0]))
                if layout == "all":
                    plans[f"no_union_sm{per_sm}"] = plan
                    fns[f"no_union_sm{per_sm}"] = (
                        lambda mask=mask, plan=plan: new_dense(
                            q, slab, mask, plan, lib=libs["new_no_union"][0]))
            errs = {name: check(name, fn(), q, slab, mask, dtype)
                    for name, fn in fns.items()}
            for name, runs in turns(fns, 30).items():
                emit({"B": B, "N": n, "d": D, "k": K, "mask": layout,
                      "key_dtype": dtype, "variant": name,
                      "sweep": "blocks_per_sm", "graph_ms": min(runs),
                      "runs_ms": runs, "split": plans[name],
                      "max_abs_err": errs[name]})
    sink.close()
    print(card)


if __name__ == "__main__":
    main()
