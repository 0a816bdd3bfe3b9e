#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:
  card      the card's name and power limit; f32 products must not use TF32
  build     nvcc of every kernel source for sm_90a, with -Xptxas -v
  kernel    each CUDA kernel (shared-mask, per-row interval and dense-mask
            cosine top-k, the per-row forms also where every row sees all
            of N (the dense mask a random four fifths of it) and where most
            rows see one region and a few all of N; k up to the IVF
            probe's 16 and past it, small
            slabs of 1 to 1,000 keys through the 4-row query tiles, k past
            N, B past one 128-row tensor-core tile, d=100, each also over
            an int8 slab with per-row scales; the IVF
            candidate top-k on the serve path's candidate matrix with its
            probe and bucket table (the grouping contract checked, k=4 and
            32, bit for bit equal to the kernel given cand alone), a skewed
            table (one full bucket of 1,024 probed by every row) and a cap
            of 100 with planted ties across two buckets, and all-visible,
            all-empty, ragged and planted-tie cases on cand alone) against
            its plain PyTorch version on the card;
            ``quantize_keys`` on the card against the CPU, bitwise
  main      the paper's serve loop (``repro_torch.launch.serve`` defaults)
            on the card for f32 and int8 slabs, with each kernel's launches
            counted, held request by request against the same run on the CPU;
            each served batch searched whole (tensor cores) and row by row
            (FMA), with the same hit decisions; then the separate
            lookup+insert path against the fused one
  tenancy   the multi-tenant serve loop (``launch.serve --tenants 4``
            defaults) the same way, through the interval kernel; then
            ``ExactIndex.search`` with a per-row (B, N) mask through the
            dense-mask kernel, against the interval search
  ivf       the IVF serve loop (``launch.serve --index ivf`` defaults) on
            the card for f32 and int8 slabs and with ``--tenants 4``, held
            against the CPU: one probe and one IVF launch per batch (the
            grouping contract checked on every batch's operands after the
            run), the same decisions, and any bucket-table difference of the
            two
            k-means runs printed and checked against a CPU engine restored
            from the card's post-refit snapshot
  quant     per-row-scale int8 lookups (``quantize_keys``, then
            ``ops.quant_cosine_topk`` and the interval wrapper) over the
            slabs the main and tenancy phases served: each served batch
            through the shared, dense-mask and interval forms, held against
            the plain versions, with the hit decisions that differ from the
            f32 search of the same slab counted
  serve_async
            the async front end (``launch.serve --scheduler async``) on the
            card at the main configuration, each engine after one warm-up
            batch: lockstep waves of 128 without coalescing held against
            the main phase's sync f32 run request by request (decisions,
            answers, scores, backend calls, device counters, Table 1; 16
            launches and the warm-up's); a closed loop of 32 clients with
            coalescing and every request traced (all answered, span sum
            within 10% of e2e at p50 and p95, every required family and
            the slab counters in a ``/metrics`` scrape over loopback, one
            ``/events`` line a batch); an open loop at half its rate;
            ``--tenants 4`` in a closed loop under DRR (one interval launch
            a batch) and in waves on the card and the CPU (same decisions
            and per-tenant counters); a pipelined TCP burst (ids echoed,
            all cached, coalesced, one error line for a malformed line);
            throughput, e2e percentiles and the stage decomposition printed
  serve_context
            sessions, the near-hit band and resilience at the main
            configuration, each engine on the card and on the CPU, held
            request by request (decisions, answers, flags, scores within
            1e-5, counters, summaries; one launch a batch): stateless
            traffic through ``DecayMeanFusion`` equal to the main run bit
            for bit; 16 record/replay conversations of 3 turns, each turn
            level's rows in a batch of 128 filled with the main workload,
            with decay and attention fusion (fused keys card vs CPU within
            1e-5) and without (fused replays hit, stateless ones not); the
            same conversations through ``run_sessions`` (16 clients; the
            sync run's replay hits) and one TCP session line; sessions over
            ``--tenants 4`` (the interval kernel); ``BandPolicy(0.75,
            0.8)`` with ``TemplateSplice(0.12)`` (exact rows equal to the
            main run, band state card vs CPU within 1e-6); and resilience
            off and on behind ``paper_tables``' fault schedule
            (availability on above off) and on with no faults (the main
            run byte for byte); wall per batch and the slice's host
            seconds (windows, canonical keys, synthesis) printed
  serve_sharded
            the sharded cache (``launch.serve --shards 4``: four shards of
            a ``DistributedCache`` on the card) at the main configuration,
            f32 and int8, against the unsharded run request by request
            (decisions, answers, scores within 1e-5, Table 1, counters, the
            slabs' key multisets; four cosine launches a batch, entries
            balanced over the shards, hits served from shards other than
            0 counted); ``--tenants 4`` (decisions and per-tenant counters)
            and ``--index ivf`` (against a CPU engine restored from the
            card's snapshot; recall@1 against the sharded exact lookup)
            on four shards; reshard on load 1 -> 4 -> 1 (strict loads
            refused, the unsharded engine's decisions); async waves of 128
            against the sync sharded run; a failing shard body (injected
            here) failing its call within 10 s, the next call served;
            wall, serve path (embedding, peek, step and their reads) and
            the cache calls' host ms a batch, sharded and not
  timing    each kernel, its plain version and one PyTorch call computing
            the same function, timed in turns with CUDA events; the
            shared-mask rows also from a CUDA graph of the wrapper's
            launches, beside cuBLAS ``q @ keys.T`` alone (TF32 off), their
            bound reckoned for 3xTF32 (2 products for int8 keys) with the
            f32-FMA bound beside it; the IVF
            probe's split and its kernel launches per call (one); the
            interval and dense forms also from a CUDA graph of what their
            wrappers launch (the row order on the card, for the dense form
            after its pass 0, then the kernel), with the rows sorted by
            interval giving each row the same top-k bit for bit, the dense
            form also where each row sees a random 80% of N, its pass 0
            held bit for bit against the plain version on each mask; all
            per-row bounds reckoned as the shared-mask rows' (3xTF32, 2
            products for int8 keys, the f32-FMA bound beside); the IVF
            kernel with and without the probe's grouping at
            the serve shape and with every id visible (the grouped call's
            bound counts cand only where a probed bucket has a live
            member, the others the whole id matrix), and the whole
            ``IVFIndex.search`` from one CUDA graph
  model     the model-backed miss path (``launch.serve --backend model``):
            the flash-attention and decode-attention kernels against their
            plain versions (causal and windowed, GQA 1-8, D 64/128, ragged
            lengths, Lk > Lq, the serve shape, four KV tiles; f32, bf16
            and int8 KV, window with sinks, rings with empty slots and
            whole empty splits, rows that see nothing, B=1, S=1, S=17,
            S=4096 and 20,000 in splits, G=16 with D=256); the main
            configuration served with full-width yi-6b (launches per batch
            with misses, finite logits, every hit decision equal to the
            main phase's, backend wall split into prefill and decode, one
            generate under torch.profiler); the first miss batch again
            through the plain attention; the reduced yi-6b card vs CPU; and
            both kernels and SDPA timed from CUDA graphs: flash at the serve
            shape, decode at the serve shape, at the fewest misses a batch
            and at yi-6b's 4,096-token context; the flash cases include
            attention sinks (under a tile, spanning tiles, past Lk, with
            Lk > Lq, windows that drop keys) and G = 5 and 6, the decode
            cases G = 5 and 6 and hymba's ring with 128 sinks
  model_families
            the moe, ssm and hybrid families behind the main configuration
            for 2 batches, each at full width in bf16: grok-1 and
            llama4-maverick at 2 layers (reduced depth), mamba2-130m and
            hymba-1.5b whole; launches per batch with misses, finite
            logits, every hit decision equal to the sim backend's in the
            main phase, backend wall split into prefill and decode, one
            generate under torch.profiler; grok-1 and hymba again through
            the plain attention (MoE rows routed apart at a router
            near-tie reported and left out); mamba2's decode continuing
            its forward (bf16, and an f32 twin); each reduced family card
            vs CPU; the flash kernel with sinks timed at hymba's serve
            shape beside its bound, the plain version and SDPA with a
            boolean mask
  model_modalities
            the audio and vlm families at full width in bf16:
            qwen2-vl-2b (all 28 layers, text only) behind the main
            configuration for 3 batches as ``model_families`` serves its
            archs (hit decisions the sim backend's, kernels vs plain
            attention), the reduced qwen2-vl card vs CPU; musicgen-large
            (all 48 layers) behind its 64-slot conditioning prefix on
            delayed codebook tokens: a prefill and 16 greedy decode steps
            (launches, finite logits, -1e9 padding columns), again through
            the plain attention fed the same tokens (bf16, and an f32
            twin), the reduced musicgen card vs CPU
  train     the flash-attention backward (row 9b) against its plain
            version over causal, window, sinks, G = 1/4/5/6, D = 64/128,
            Lk > Lq, Lk < Lq (rows that see nothing), not causal, f32 and
            bf16 (within 1e-4 / 2e-2 of the largest |gradient|), the
            forward's log-sum-exp against the plain one and its output
            unmoved, two runs bit for bit; one training step of qwen2-vl
            (full width, f32, 4 layers) through the kernels against plain
            attention, every gradient; ``launch.train --arch qwen2-vl-2b
            --full`` for 10 AdamW steps on a fixed batch and musicgen-large
            through ``loss_fn`` for 6 steps at full width, the loss
            falling, the kernels' launches counted; row 9b timed at the
            qwen2-vl step's shape beside its bound, its plain version and
            SDPA's backward, and row 9 with and without the log-sum-exp
  tools     the last modules: the MiniLM encoder at full width on the card
            over the main configuration's 2,000 test queries (16 batches
            of 128), every row within 1e-5 of the same weights on the CPU
            and of unit norm, a batch timed by events and from a CUDA
            graph beside its bound and the host HashEmbedder's time a
            batch; the port's HNSW over 2,048 keys of d=384, its top-1 for
            128 noisy queries against the cosine kernel's exact top-1 on
            the card (at least 0.9 agree); the dry run's sharded cache pair
            (``DistributedCache.make_lookup_insert``, four shards, capacity
            1,048,576, B=256, f32 and int8) on the card beside its roofline
            terms, and two model pairs on the meta device
  mesh      the multi-chip path on the one card: full-width yi-6b cut to
            2 layers (bf16) as a ``Model`` on a (1, 1) mesh of one NCCL rank
            (DTensor parameters, the attention kernels under ``local_map``),
            its prefill and 4 decode steps bit for bit equal to the
            unsharded model's, the flash and decode kernels launched; the
            production dry run in the fake world (grok-1 decode_32k with
            the sharded MoE and yi-6b train_4k on ``pod_16x16``, yi-6b
            train_4k on ``multipod_2x16x16``: per-chip bytes, collectives
            by kind, the dominant roofline term, seconds); the cache pair at
            the pod's 16 shards on the card, f32 and int8, ms a step beside
            its per-chip roofline terms
Each phase's seconds follow it on a ``phase_seconds`` line, and all of
them come before the end. The last three lines are the card's name and
power limit as nvidia-smi gives them, the per-kernel summary, and
``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
    print(f"chip_smoke: FAIL: no src/repro_torch beside {Path(__file__).name}:"
          " run it from a checkout of the repository", file=sys.stderr)
    sys.exit(1)
sys.path.insert(0, str(SRC))

# published H100 SXM peaks (NVIDIA data sheet), one source with the roofline
# model: f32 outside the tensor cores, dense TF32 and bf16 on them, and HBM3
# bandwidth
from repro_torch.launch.roofline import (PEAK_BF16_FLOPS,  # noqa: E402
                                         PEAK_BYTES, PEAK_F32_FLOPS,
                                         PEAK_TF32_FLOPS)
# bf16 keys and the plain version's operands are the same bf16 numbers, exact
# in f32, so bf16 is held to the f32 tolerance
SCORE_TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 1e-5, "quant": 1e-5}
MAIN_BATCHES = 16          # 2,000 test queries in batches of 128
TENANTS = 4                # launch.serve --tenants 4: 4 x 16,384 slots
KERNELS = ("cosine_topk", "cosine_topk_interval", "cosine_topk_masked",
           "ivf_topk", "flash_attention", "flash_attention_bwd",
           "decode_attention", "quant_cosine_topk",
           "quant_cosine_topk_interval", "quant_cosine_topk_masked")
DECISION_FIELDS = ("lookups", "cache_hits", "hit_rate", "api_call_fraction")
THRESHOLD = 0.8


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


def _as_f32(torch, keys, scales=None):
    """f32 keys for a library yardstick: int8 keys times their per-row
    ``scales``, else divided by 127 (the uniform slab quantization)."""
    if scales is not None:
        return keys.float() * scales[:, None]
    return keys.float() / 127.0 if keys.dtype == torch.int8 else keys.float()


def _compare(torch, ks, ki, rs1, ri1, k, tol, where, tie_rows):
    """Hold a kernel's (scores, ids) against its plain version's top-(k+1)
    (one entry more, for the gap past the kernel's last entry). Returns the
    max abs score error over the finite entries. ``tie_rows`` maps a row to
    the slot ids its planted ties must resolve to, in order. The plain
    version returns min(k+1, N) entries; past N the kernel's must be
    (-inf, -1)."""
    torch.cuda.synchronize()
    ks, ki, rs1, ri1 = (x.cpu() for x in (ks, ki, rs1, ri1))
    b = ks.shape[0]
    if rs1.shape[1] < k + 1:
        pad = k + 1 - rs1.shape[1]
        rs1 = torch.cat([rs1, torch.full((b, pad), -math.inf)], dim=1)
        ri1 = torch.cat([ri1, torch.full((b, pad), -1, dtype=ri1.dtype)],
                        dim=1)
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
            fail(f"planted ties not resolved by the tie rule at "
                 f"{where}: row {r} kernel {ki[r].tolist()}, plain "
                 f"{ri[r].tolist()}, expected {want.tolist()}")
    return err


def _kernel_case(torch, dtype, b, n, d, k, mask, seed):
    """One comparison of the shared-mask kernel with its plain version
    (``dtype="quant"``: the per-row-scale kernel, on f32 keys quantized after
    the ties are planted, so the tie rows are equal in int8 and scale).
    Returns the max abs score error over the finite entries."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    quant = dtype == "quant"
    keys = _make_keys(torch, gen, n, d, "f32" if quant else dtype)
    # planted exact ties: equal copies of one key row at slots t0 < t1 < t2
    # (fewer where N < 3), and the first query rows are that row itself
    tie_slots = sorted({n // 5, n // 2, n - 1})
    t0 = tie_slots[0]
    for t in tie_slots[1:]:
        keys[t] = keys[t0]
    q = torch.randn((b, d), generator=gen, device="cuda")
    n_tie_rows = min(b, 3)
    q[:n_tie_rows] = _as_f32(torch, keys[t0])
    q = q / q.norm(dim=1, keepdim=True)
    ties = torch.tensor(tie_slots, device="cuda")
    if mask == "all":
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
    elif mask == "none":
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
    elif mask == "few":
        # k - 1 visible slots where N allows: the ties and other slots
        valid = torch.zeros(n, dtype=torch.bool, device="cuda")
        others = torch.randperm(n, generator=gen, device="cuda")[:k + 3]
        valid[others[~torch.isin(others, ties)][:max(k - 1 - len(ties), 0)]
              ] = True
    else:
        valid = torch.rand(n, generator=gen, device="cuda") < 0.7
    if mask != "none":
        valid[ties] = True
    # the slab operands: (keys,) or (int8 keys, per-row scales)
    slab = kmod.quantize_keys(keys) if quant else (keys,)
    prefix = "quant_" if quant else ""
    ks, ki = getattr(kmod, f"{prefix}cosine_topk_cuda")(q, *slab, valid, k)
    rs1, ri1 = getattr(ref, f"{prefix}cosine_topk_ref")(q, *slab, valid,
                                                       k + 1)
    tie_rows = {} if mask == "none" else \
        {r: tie_slots for r in range(n_tie_rows)}
    return _compare(torch, ks, ki, rs1, ri1, k, SCORE_TOL[dtype],
                    f"{dtype} B={b} N={n} d={d} k={k} mask={mask}", tie_rows)


def _intervals(torch, gen, b, n, layout):
    """(starts, sizes) (B,) int32 on the card. ``regions``: TENANTS equal
    contiguous regions, a random one per row, every fifth row empty (a
    padded row); ``random``: random intervals that cross 128-key tiles and
    pass-1 chunks, every fourth row empty; ``unstructured``: every row all
    of N (the dense-mask case then knocks out a random fifth of each row's
    slots, independently), every fifth row empty; ``skewed``: most rows the
    first region, every eighth row all of N, every fifth row empty;
    ``empty``: every row empty."""
    if layout in ("unstructured", "skewed"):
        size = n // TENANTS if layout == "skewed" else n
        starts = torch.zeros(b, dtype=torch.long, device="cuda")
        sizes = torch.full((b,), size, dtype=torch.long, device="cuda")
        sizes[::8] = n
        sizes[4::5] = 0
    elif layout == "regions":
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


def _tile_summary_check(torch, mask, where) -> None:
    """The dense form's pass 0 and row ranking on the card
    (``cosine_topk.tile_summary``) against their plain versions on
    ``mask``: bitmaps, sort keys and tile counts equal to
    ``ref.tile_summary_ref``'s bit for bit, the order a stable sort of the
    keys; or fail."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    *got, order = kmod.tile_summary(mask)
    want = ref.tile_summary_ref(mask)
    for label, g, w in zip(("bitmaps", "sort keys", "tile counts"), got,
                           want):
        if not torch.equal(g, w):
            fail(f"tile_summary {label} differ from the plain version at "
                 f"{where}")
    if not torch.equal(order.long(),
                       torch.sort(want[1], stable=True).indices):
        fail(f"tile_summary's order is not a stable sort of its keys at "
             f"{where}")


def _per_row_case(torch, variant, dtype, b, n, d, k, layout, seed):
    """One comparison of the interval (``variant="interval"``) or dense-mask
    (``"masked"``) kernel with its plain version. Planted ties across a
    region edge e: slots e-1, e and e+1 hold one key row; query rows 0, 1, 2
    are that row and see [0, e), [e, n) and [e+1, n), so each must find only
    the copies inside its own interval, lowest slot first
    (``dtype="quant"``: the per-row-scale kernels, keys quantized after the
    ties are planted). Returns the max abs score error."""
    from repro_torch.core.similarity import interval_visibility
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    quant = dtype == "quant"
    keys = _make_keys(torch, gen, n, d, "f32" if quant else dtype)
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
    # the slab operands: (keys,) or (int8 keys, per-row scales)
    slab = kmod.quantize_keys(keys) if quant else (keys,)
    prefix = "quant_" if quant else ""
    if variant == "interval":
        ks, ki = getattr(kmod, f"{prefix}cosine_topk_interval_cuda")(
            q, *slab, valid, starts, sizes, k)
        rs1, ri1 = getattr(ref, f"{prefix}cosine_topk_interval_ref")(
            q, *slab, valid, starts, sizes, k + 1)
    else:
        # a non-contiguous per-row mask: the row's interval and valid slots,
        # a fifth of them knocked out (never the planted ties)
        mask = interval_visibility(valid, starts, sizes) & (
            torch.rand((b, n), generator=gen, device="cuda") < 0.8)
        for r in tie_rows:
            mask[r] = interval_visibility(valid, starts[r:r + 1],
                                          sizes[r:r + 1])[0]
        _tile_summary_check(torch, mask, f"{dtype} B={b} N={n} {layout}")
        ks, ki = getattr(kmod, f"{prefix}cosine_topk_masked_cuda")(
            q, *slab, mask, k)
        rs1, ri1 = getattr(ref, f"{prefix}cosine_topk_ref")(q, *slab, mask,
                                                           k + 1)
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
        (128, 128, 384, 16, "all"),        # the IVF serve probe
        (128, 16384, 384, 16, "random"),
        (7, 1000, 384, 32, "few"),
        # small N, where the split takes 4-row query tiles: one chunk (N <=
        # 128, no merge) or several; k past N; planted ties wherever N >= 3
        (1, 1, 384, 1, "random"),
        (7, 1, 384, 16, "random"),
        (200, 31, 384, 16, "few"),
        (7, 31, 384, 32, "random"),
        (1, 128, 384, 16, "random"),
        (200, 128, 384, 16, "random"),
        (128, 128, 384, 16, "few"),
        (7, 129, 384, 32, "random"),
        (200, 129, 384, 1, "random"),
        (1, 1000, 384, 32, "few"),
        (200, 1000, 384, 16, "random"),
        (7, 1000, 1536, 1, "random"),
        # past one 128-row tensor-core tile; d = 100, not a whole 32-dim
        # slice (f32 rows by cp.async, bf16 and int8 rows by plain loads)
        (129, 16385, 100, 4, "random"),
        (129, 16383, 384, 16, "random"),
    ]
    per_row_cases = [  # (B, N, d, k, interval layout)
        (128, 65536, 384, 4, "regions"),    # the tenancy path's shape
        (200, 16383, 384, 8, "random"),     # B > 64, N % 128 != 0
        (70, 1000, 1536, 8, "random"),
        (7, 1000, 384, 4, "regions"),
        (128, 1000, 384, 4, "empty"),
        (200, 1048576, 384, 4, "regions"),
        (7, 1000, 384, 1, "regions"),
        (70, 16383, 1536, 16, "random"),
        (9, 1000, 384, 32, "random"),
        # the dense form's grouping: no tile to skip; most rows one region
        (128, 65536, 384, 4, "unstructured"),
        (128, 65536, 384, 4, "skewed"),
        (200, 16383, 384, 8, "skewed"),
        (7, 1000, 384, 4, "unstructured"),
    ]
    worst = dict.fromkeys(KERNELS, 0.0)
    # "quant": int8 keys with per-row scales, the quant_* kernels
    for dtype in ("f32", "bf16", "int8", "quant"):
        prefix = "quant_" if dtype == "quant" else ""
        name = f"{prefix}cosine_topk"
        errs = [_kernel_case(torch, dtype, b, n, d, k, mask, seed=1000 + i)
                for i, (b, n, d, k, mask) in enumerate(cases)]
        emit("kernel", kernel=name, dtype=dtype, cases=len(cases),
             max_abs_err=max(errs), tolerance=SCORE_TOL[dtype])
        worst[name] = max(worst[name], max(errs))
        for variant in ("interval", "masked"):
            errs = [_per_row_case(torch, variant, dtype, b, n, d, k, layout,
                                  seed=2000 + i)
                    for i, (b, n, d, k, layout) in enumerate(per_row_cases)]
            name = f"{prefix}cosine_topk_{variant}"
            emit("kernel", kernel=name, dtype=dtype,
                 cases=len(per_row_cases), max_abs_err=max(errs),
                 tolerance=SCORE_TOL[dtype])
            worst[name] = max(worst[name], max(errs))
    emit("kernel", check="dense pass 0 and row ranking card == plain, "
         "bitwise", masks=4 * len(per_row_cases))
    worst["ivf_topk"] = _ivf_kernel_cases(torch)
    _quantize_keys_check(torch)
    return worst


def _quantize_keys_check(torch) -> None:
    """``quantize_keys`` on the card is bitwise the CPU's, zero rows too."""
    from repro_torch.kernels.cosine_topk import quantize_keys
    gen = torch.Generator(device="cuda").manual_seed(41)
    for n, d in ((16384, 384), (16383, 1536)):
        keys = _make_keys(torch, gen, n, d, "f32")
        keys[7] = 0.0
        cq, cs = quantize_keys(keys)
        hq, hs = quantize_keys(keys.cpu())
        if not (torch.equal(cq.cpu(), hq) and torch.equal(
                cs.cpu().view(torch.int32), hs.view(torch.int32))):
            fail(f"quantize_keys on the card differs from the CPU at "
                 f"N={n} d={d}")
        emit("kernel", check="quantize_keys card == cpu, bitwise", N=n, d=d)


def _ivf_serve_candidates(torch, b=128):
    """The IVF serve path's operands at its defaults: the warm f32 slab
    after the first refit, the first ``b`` served queries (normalized),
    their (B, M) candidate matrix, and the grouping ``IVFIndex.search``
    passes with it: the probe (B, P) int32 and the bucket table (C, cap)."""
    from repro_torch.core import store
    from repro_torch.core.similarity import l2_normalize
    from repro_torch.launch import serve
    eng, reqs = serve.build(device="cuda", index="ivf", log=lambda *a: None)
    eng._maybe_refit()
    q = l2_normalize(eng._embed([r.query for r in reqs[:b]]))
    alive = store.alive_mask(eng.state, eng._now)
    st = eng.runtime.index_state
    cand, probe = eng.cache.index.probe_candidates(st, q, alive)
    return eng, q, eng.state.keys, cand, probe, st.buckets


def _ivf_case(torch, dtype, q, keys, cand, k, where, tie_rows=None,
              groups=None):
    """The IVF kernel against its plain version on f32 ``keys`` cast to
    ``dtype``; returns the max abs score error. With ``groups`` (probe,
    buckets) the kernel runs bucket by bucket, and its output must also
    equal, bit for bit, that of the same kernel given cand alone."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ivf_topk import ivf_topk_cuda
    if dtype == "bf16":
        keys = keys.to(torch.bfloat16)
    elif dtype == "int8":
        keys = torch.clamp(torch.round(keys * 127.0), -127, 127).to(
            torch.int8)
    kw = {} if groups is None else dict(probe=groups[0], buckets=groups[1])
    ks, ki = ivf_topk_cuda(q, keys, cand, k, **kw)
    rs1, ri1 = ref.ivf_topk_ref(q, keys, cand, k + 1)
    err = _compare(torch, ks, ki, rs1, ri1, k, SCORE_TOL[dtype],
                   f"ivf_topk {dtype} {where}", tie_rows or {})
    if groups is not None:
        us, ui = ivf_topk_cuda(q, keys, cand, k)
        if not (torch.equal(ks.view(torch.int32), us.view(torch.int32))
                and torch.equal(ki, ui)):
            fail(f"ivf_topk {dtype} {where}: the grouped and ungrouped "
                 "forms differ")
    return err


def _grouped_table(torch, gen, b, c, cap, p, n, d):
    """A seeded grouped table on the card: unit keys, queries, a bucket
    table whose bucket 0 is full and probed by every row (the skew), the
    others a random share live, and cand = buckets[probe] with a third of
    it -1. Planted ties across two buckets: slots u1 < u2 hold one key row,
    row 0's query is that row, u2 sits in the bucket row 0 probes first and
    u1 in the next, so row 0 must return u2 before u1."""
    keys = _make_keys(torch, gen, n, d, "f32")
    q = torch.randn((b, d), generator=gen, device="cuda")
    u1, u2 = n // 3, n // 2
    keys[u2] = keys[u1]
    q[0] = keys[u1]
    q = q / q.norm(dim=1, keepdim=True)
    slots = torch.randint(0, n, (c, cap), generator=gen, device="cuda",
                          dtype=torch.int32)
    slots[torch.isin(slots, torch.tensor([u1, u2], device="cuda"))] = 0
    share = torch.rand((c, 1), generator=gen, device="cuda")
    live = torch.rand((c, cap), generator=gen, device="cuda") < share
    live[0] = True
    buckets = torch.where(live, slots, -1).to(torch.int32)
    rest = torch.argsort(torch.rand((b, c - 1), generator=gen,
                                    device="cuda"), dim=1) + 1
    probe = torch.cat([torch.zeros((b, 1), dtype=torch.long,
                                   device="cuda"), rest[:, :p - 1]], 1)
    probe[0, :3] = torch.tensor([2, 3, 0], device="cuda")
    probe[0, 3:] = rest[0][~torch.isin(rest[0], torch.tensor(
        [2, 3], device="cuda"))][:p - 3]
    probe = probe.to(torch.int32).contiguous()
    buckets[2, 0], buckets[3, 0] = u2, u1
    cand = buckets[probe.long()].reshape(b, p * cap)
    cand[torch.rand(cand.shape, generator=gen, device="cuda") < 1 / 3] = -1
    cand[0, 0], cand[0, cap] = u2, u1
    return q, keys, cand.contiguous(), probe, buckets, [u2, u1]


def _ivf_kernel_cases(torch) -> float:
    """Every IVF kernel case for f32, bf16 and int8 keys; returns the worst
    score error. The serve shape's cases run grouped (the probe and bucket
    table ``IVFIndex.search`` passes), the rest on cand alone."""
    from repro_torch.kernels.ivf_topk import check_contract
    _, q, keys, cand, probe, buckets = _ivf_serve_candidates(torch)
    check_contract(cand, probe, buckets)
    emit("kernel", check="ivf_topk grouping contract on the serve operands",
         visible=int((cand >= 0).sum()))
    groups = (probe, buckets)
    keys = keys.float()
    gen = torch.Generator(device="cuda").manual_seed(31)
    n, d = keys.shape
    every = torch.randint(0, n, cand.shape, generator=gen, device="cuda",
                          dtype=torch.int32)
    # B > 64, M past one 2,048-position chunk and not a multiple of it,
    # ids a tenth visible, rows 0-9 with fewer visible ids than k
    rk = _make_keys(torch, gen, 5000, d, "f32")
    rq = torch.randn((200, d), generator=gen, device="cuda")
    rq = rq / rq.norm(dim=1, keepdim=True)
    ragged = torch.randint(0, 5000, (200, 3001), generator=gen, device="cuda",
                           dtype=torch.int32)
    ragged[torch.rand((200, 3001), generator=gen, device="cuda") < 0.9] = -1
    for r in range(10):
        ragged[r, r:] = -1
        ragged[r, 3001 - r:] = 7
    # planted equal scores: slots u2 and u1 hold one key row, at positions
    # 100 and 900 of row 0 (its query); slot t at positions 5 and 700 of
    # row 1. Ties go to the lower position, and no dedup happens here.
    tk = _make_keys(torch, gen, 4096, d, "f32")
    tq = torch.randn((128, d), generator=gen, device="cuda")
    u1, u2, t = 1000, 3000, 2000
    tk[u2] = tk[u1]
    tq[0], tq[1] = tk[u1], tk[t]
    tq = tq / tq.norm(dim=1, keepdim=True)
    tc = torch.randint(0, 4096, (128, 1024), generator=gen, device="cuda",
                       dtype=torch.int32)
    tc[torch.isin(tc, torch.tensor([u1, u2, t], device="cuda"))] = -1
    tc[0, 100], tc[0, 900], tc[1, 5], tc[1, 700] = u2, u1, t, t
    # the grouped form: planted ties across two probed buckets, a skewed
    # table (one full bucket of 1,024 members probed by all 128 rows), and
    # a cap of 100
    sq, sk, sc, sp, sb, sties = _grouped_table(torch, gen, 128, 24, 1024, 16,
                                               20000, d)
    check_contract(sc, sp, sb)
    cq, ck, cc, cp, cb, cties = _grouped_table(torch, gen, 60, 12, 100, 5,
                                               900, d)
    worst = 0.0
    for dtype in ("f32", "bf16", "int8"):
        errs = [
            _ivf_case(torch, dtype, q, keys, cand, 4, "serve shape",
                      groups=groups),
            _ivf_case(torch, dtype, q, keys, cand, 32, "serve shape k=32",
                      groups=groups),
            _ivf_case(torch, dtype, q, keys, every, 4, "all visible"),
            _ivf_case(torch, dtype, q, keys, torch.full_like(cand, -1), 4,
                      "all -1", groups=groups),
            _ivf_case(torch, dtype, rq, rk, ragged, 8, "B=200 M=3001 k=8"),
            _ivf_case(torch, dtype, tq, tk, tc, 4, "planted ties",
                      {0: [u2, u1], 1: [t, t]}),
            _ivf_case(torch, dtype, sq, sk, sc, 4, "skewed table, ties "
                      "across buckets", {0: sties}, groups=(sp, sb)),
            _ivf_case(torch, dtype, cq, ck, cc, 8, "cap 100, ties across "
                      "buckets", {0: cties}, groups=(cp, cb)),
        ]
        emit("kernel", kernel="ivf_topk", dtype=dtype, cases=len(errs),
             max_abs_err=max(errs), tolerance=SCORE_TOL[dtype],
             grouped_equals_ungrouped="bitwise, 5 grouped cases")
        worst = max(worst, max(errs))
    return worst


# --------------------------------------------------------------------- #
def _kernel_modules():
    from repro_torch.kernels import (cosine_topk, decode_attention,
                                     flash_attention, ivf_topk)
    return cosine_topk, ivf_topk, flash_attention, decode_attention


def _reset_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def _launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def _serve(torch, **kw):
    """One ``launch.serve.run``; returns the engine, requests, responses,
    each kernel's launches during the run, and its wall time."""
    from repro_torch.launch import serve
    _reset_launches()
    t0 = time.perf_counter()
    engine, requests, responses = serve.run(log=lambda *a: None, **kw)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, requests, responses, _launches(), wall


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


def phase_main(torch) -> tuple[int, dict, tuple, dict]:
    """The paper's serve loop on the card against the CPU. Returns the
    cosine kernel's launches, the Table 1 hits of the f32 run, its
    (engine, requests), and its responses, device counters, backend calls
    and per-category summary (the async phase's reference)."""
    main_launches, hits, served, sync = None, None, None, None
    for key_dtype in ("f32", "int8"):
        eng, reqs, resp, launches, wall = _serve(torch, device="cuda",
                                                 key_dtype=key_dtype)
        _expect_launches(launches, {"cosine_topk": MAIN_BATCHES},
                         f"main path ({key_dtype})")
        if key_dtype == "f32":
            main_launches = launches["cosine_topk"]
            served = (eng, reqs)
            hits = {c: m["cache_hits"] for c, m in
                    eng.metrics.summary()["categories"].items()}
            sync = {"responses": resp, "stats": eng.stats.host(),
                    "calls": eng.backend.calls,
                    "categories": eng.metrics.summary()["categories"]}
            _batch_size_check(torch, resp)
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
    return main_launches, hits, served, sync


def _batch_size_check(torch, served) -> None:
    """The main path's f32 stream served again on a fresh engine, where
    every batch's search over the slab, as that batch finds it, is made
    whole (128 rows: tensor-core tiles, 3xTF32) and one row at a time (4-row
    tiles, f32 FMAs). The hit decisions at THRESHOLD must agree, and the
    replay's responses must be ``served``'s. Prints the largest score
    difference between the two forms (ROADMAP, Queue C), how many rows miss
    and the closest score to THRESHOLD."""
    from repro_torch.core import index as index_mod
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.launch import serve
    ops = index_mod.ops
    search = ops.cosine_topk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seen = {"diff": 0.0, "flips": 0, "rows": 0, "misses": 0,
            "closest": math.inf}

    def both_forms(q, keys, alive, *, k):
        # one search a batch (the fused step's peek); its pad rows left out
        n_valid = next(batch_rows)
        forms = {kmod.split(b, keys.shape[0], sms, shared=True)[2]
                 for b in (q.shape[0], 1)}
        if forms != {kmod.BLOCK_Q_TC, kmod.BLOCK_Q_NARROW}:
            fail(f"batch-size check: the forms compared are {forms}")
        out = search(q, keys, alive, k=k)
        whole = out[0][:n_valid, 0]
        single = torch.cat([search(q[r:r + 1], keys, alive, k=k)[0]
                            for r in range(n_valid)])[:, 0]
        if not torch.equal(torch.isfinite(whole), torch.isfinite(single)):
            fail("batch-size check: a row sees slots in one form only")
        fin = torch.isfinite(whole)
        if fin.any():
            seen["diff"] = max(seen["diff"], float(
                (whole[fin] - single[fin]).abs().max()))
            seen["closest"] = min(seen["closest"], float(
                (whole[fin] - THRESHOLD).abs().min()))
        seen["flips"] += int(((whole >= THRESHOLD)
                              != (single >= THRESHOLD)).sum())
        seen["misses"] += int((whole < THRESHOLD).sum())
        seen["rows"] += n_valid
        return out

    eng, reqs = serve.build(device="cuda", key_dtype="f32",
                            log=lambda *a: None)
    batch_rows = iter([len(b) for b in eng.batcher.batches(reqs)])
    ops.cosine_topk = both_forms
    try:
        resp = eng.process(reqs)
    finally:
        ops.cosine_topk = search
    torch.cuda.synchronize()
    _same_decisions(resp, served, "batch-size replay vs the main path", 0.0)
    if seen["rows"] != len(reqs):
        fail(f"batch-size check: {seen['rows']} of {len(reqs)} rows compared")
    if seen["flips"]:
        fail(f"batch-size check: {seen['flips']} hit decisions differ "
             "between a batch of 128 and one row at a time")
    if not seen["diff"] <= SCORE_TOL["f32"]:
        fail(f"batch-size check: scores differ by {seen['diff']}")
    emit("main", check="batch of 128 (tensor cores) vs one row (FMA), "
         "each batch over the slab as it was served", rows=seen["rows"],
         max_score_diff=seen["diff"], hit_decisions_differing=seen["flips"],
         rows_below_threshold=seen["misses"],
         closest_score_to_threshold=seen["closest"])


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


def phase_tenancy(torch) -> tuple[dict, tuple]:
    """The multi-tenant serve path on the card, against the CPU. Returns
    the interval and dense-mask kernels' launches on their paths and the
    f32 run's (engine, requests)."""
    out, served = {}, None
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
            served = (eng, reqs)
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
    return out, served


# --------------------------------------------------------------------- #
def _table_diff(a, b) -> int:
    """Entries in which two IVF states' bucket tables differ."""
    return int((a.buckets.cpu() != b.buckets.cpu()).sum()
               + (a.bucket_valid.cpu() != b.bucket_valid.cpu()).sum())


def _ivf_run(torch, device, snapshot=None, on_warm_slab=None, **kw):
    """``launch.serve --index ivf`` on ``device``, with the first batch's
    refit run up front, as ``serve_batch`` would run it. After the refit it
    saves a snapshot when ``snapshot`` is given and calls
    ``on_warm_slab(engine, requests)``, outside the counted and timed run.
    Returns the engine, requests, responses, the post-refit index state,
    the launches while serving, the wall time of build + serve and what
    ``on_warm_slab`` returned."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    eng, reqs = serve.build(device=device, index="ivf", log=lambda *a: None,
                            **kw)
    eng._maybe_refit()
    refit_state = eng.runtime.index_state
    wall = time.perf_counter() - t0
    if snapshot is not None:
        eng.save_cache(snapshot)
    extra = None if on_warm_slab is None else on_warm_slab(eng, reqs)
    _reset_launches()
    with _ivf_operands() as operands:
        t0 = time.perf_counter()
        resp = eng.process(reqs)
        if device == "cuda":
            torch.cuda.synchronize()
        wall += time.perf_counter() - t0
    if device == "cuda":
        from repro_torch.kernels.ivf_topk import check_contract
        shards = kw.get("shards", 0)
        calls = MAIN_BATCHES * (len(shards) if isinstance(shards, list)
                                else max(1, shards))
        if len(operands) != calls:
            fail(f"ivf_topk got {len(operands)} grouped calls, not {calls}")
        for cand, probe, buckets in operands:
            check_contract(cand, probe, buckets)
    return eng, reqs, resp, refit_state, _launches(), wall, extra


class _ivf_operands:
    """Keeps the (cand, probe, buckets) of every ``ops.ivf_topk`` call made
    with the grouping while it is entered, without waiting for the card, so
    that the contract can be checked after the timed run."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.original, self.seen = ops, ops.ivf_topk, []

        def keep(queries, keys, cand, **kw):
            if kw.get("probe") is not None:
                self.seen.append((cand, kw["probe"], kw["buckets"]))
            return self.original(queries, keys, cand, **kw)
        ops.ivf_topk = keep
        return self.seen

    def __exit__(self, *exc):
        self.ops.ivf_topk = self.original


def _decisions(eng) -> dict:
    return {c: {f: m[f] for f in DECISION_FIELDS}
            for c, m in eng.metrics.summary()["categories"].items()}


def _n_differing(a, b) -> int:
    return sum(x.cached != y.cached or x.answer != y.answer
               or not abs(x.score - y.score) <= 1e-5 for x, y in zip(a, b))


def _warm_slab_stats(eng, reqs) -> dict:
    """On the warm slab after the refit: bucket fill, the visible candidates
    per row of the first batch, and recall@1 of the IVF search against
    ExactIndex over every request: the IVF top-1 scores what the exact
    top-1 scores, within 1e-6 (the same slot, or an equal key, as the
    copies of the corpus in every tenant region are)."""
    from repro_torch.core import store
    from repro_torch.core.index import ExactIndex
    from repro_torch.core.similarity import l2_normalize
    st, keys = eng.runtime.index_state, eng.state.keys
    alive = store.alive_mask(eng.state, eng._now)
    fill = st.bucket_valid.sum(1).float()
    same, visible = 0, None
    for i in range(0, len(reqs), 128):
        q = l2_normalize(eng._embed([r.query for r in reqs[i:i + 128]]))
        if visible is None:
            cand = eng.cache.index.candidates(st, q, alive)
            visible = (cand >= 0).sum(1).float()
        iv, _ = eng.cache.index.search(st, q, keys, alive)
        ex, _ = ExactIndex(topk=1).search(None, q, keys, alive)
        same += int(((iv[:, 0] - ex[:, 0]).abs() <= 1e-6).sum())
    return {"bucket_fill": {"min": int(fill.min()),
                            "mean": float(fill.mean()),
                            "max": int(fill.max())},
            "visible_candidates_first_batch": {
                "min": int(visible.min()), "mean": float(visible.mean()),
                "max": int(visible.max()), "of": cand.shape[1]},
            "recall_at_1_vs_exact": same / len(reqs)}


def phase_ivf(torch, scratch: Path) -> dict:
    """The IVF serve path on the card against the CPU. Returns the
    launches of the f32 run."""
    from repro_torch.launch import serve
    out = {}
    for i, kw in enumerate((dict(key_dtype="f32"), dict(key_dtype="int8"),
                            dict(key_dtype="f32", tenants=TENANTS))):
        where = "ivf " + " ".join(f"{k}={v}" for k, v in kw.items())
        snap = str(scratch / f"ivf-{i}")
        eng, reqs, resp, refit_st, launches, wall, warm = _ivf_run(
            torch, "cuda", snapshot=snap, on_warm_slab=_warm_slab_stats, **kw)
        _expect_launches(launches, {"cosine_topk": MAIN_BATCHES,
                                    "ivf_topk": MAIN_BATCHES}, where)
        emit("ivf", check="grouping contract held on every served batch's "
             "operands", where=where, batches=MAIN_BATCHES)
        scores = [r.score for r in resp]
        if len(resp) != len(reqs) or not all(math.isfinite(x)
                                             for x in scores):
            fail(f"{where}: missing or non-finite scores")
        cpu, _, cpu_resp, cpu_refit_st, cpu_launches, cpu_wall, _ = \
            _ivf_run(torch, "cpu", **kw)
        _expect_launches(cpu_launches, {}, f"{where}, CPU run")
        refit_diff = _table_diff(refit_st, cpu_refit_st)
        centroid_diff = float((refit_st.centroids.cpu()
                               - cpu_refit_st.centroids).abs().max())
        final_diff = _table_diff(eng.runtime.index_state,
                                 cpu.runtime.index_state)
        restored = None
        if refit_diff == 0 and final_diff == 0:
            _same_decisions(resp, cpu_resp, f"{where} cuda vs cpu", 1e-5)
            ref_eng = cpu
        else:
            # the two k-means runs or absorbs placed a key differently (an
            # f32 near-tie of two centroids): hold the card's decisions
            # against a CPU engine restored from the card's own post-refit
            # snapshot, which serves from the card's bucket tables
            ref_eng, rreqs = serve.build(device="cpu", index="ivf",
                                         log=lambda *a: None, **kw)
            ref_eng.load_cache(snap)
            rresp = ref_eng.process(rreqs)
            _same_decisions(resp, rresp, f"{where} cuda vs restored cpu",
                            1e-5)
            restored = {"requests": len(rresp), "table_entries_differing":
                        _table_diff(eng.runtime.index_state,
                                    ref_eng.runtime.index_state)}
        if _decisions(eng) != _decisions(ref_eng):
            fail(f"{where}: per-category hits differ from the CPU")
        if kw.get("tenants") and eng.tenant_stats() != ref_eng.tenant_stats():
            fail(f"{where}: tenant_stats differ from the CPU")
        cats = eng.metrics.summary()["categories"]
        emit("ivf", device="cuda", **kw, capacity=eng.cache.config.capacity,
             requests=len(resp), batches=MAIN_BATCHES,
             kernel_launches=launches, refits=eng.refits, wall_s=wall,
             wall_per_batch_s=wall / MAIN_BATCHES,
             serve_path_s=eng.metrics.cache_path_time_s, cpu_wall_s=cpu_wall,
             closest_score_to_threshold=min(abs(x - THRESHOLD)
                                            for x in scores),
             **warm,
             table_entries_differing_after_refit=refit_diff,
             centroid_max_abs_diff_after_refit=centroid_diff,
             table_entries_differing_after_serving=final_diff,
             requests_differing_from_cpu_run=_n_differing(resp, cpu_resp),
             restored_cpu_check=restored,
             table1={c: {"hits": m["cache_hits"], "lookups": m["lookups"],
                         "hit_rate": m["hit_rate"],
                         "positive_hits": m["positive_hits"]}
                     for c, m in cats.items()},
             cpu_hits={c: m["cache_hits"] for c, m in
                       cpu.metrics.summary()["categories"].items()})
        if i == 0:
            out = launches
    return out


# --------------------------------------------------------------------- #
def _quant_batches(torch, eng, reqs, slab: str) -> list:
    """Each served batch's normalized queries with the visibility operands
    of its per-row-scale kernels: on the main slab the shared alive mask
    (``quant_cosine_topk``) and a (B, N) mask of four contiguous regions,
    row r seeing region r % 4, and alive (``quant_cosine_topk_masked``); on
    the tenant slab the registry's per-row intervals
    (``quant_cosine_topk_interval``)."""
    from repro_torch.core import store
    from repro_torch.core.similarity import interval_visibility, l2_normalize
    alive = store.alive_mask(eng.state, eng._now)
    n = alive.shape[0]
    batches = []
    for i in range(0, len(reqs), eng.batcher.batch_size):
        chunk = reqs[i:i + eng.batcher.batch_size]
        q = l2_normalize(eng._embed([r.query for r in chunk]))
        if slab == "main":
            region = n // TENANTS
            rows = torch.arange(q.shape[0], device=q.device) % TENANTS
            starts = (rows * region).to(torch.int32)
            operands = {"quant_cosine_topk": alive,
                        "quant_cosine_topk_masked": interval_visibility(
                            alive, starts, torch.full_like(starts, region))}
        else:
            operands = {"quant_cosine_topk_interval": (
                alive, *eng.cache._tenant_interval(eng._tenant_ids(chunk)))}
        batches.append((q, operands))
    return batches


def _quant_search(torch, name, q, slab, op, k, plain=False):
    """One search of the per-row-scale form ``name`` (its CUDA path, or
    with ``plain`` its plain version) over ``slab`` = (int8 keys, scales);
    ``op`` is the mask or the (alive, starts, sizes) operands. With ``slab``
    a 1-tuple of f32 keys, the f32 search of the same visibility."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ops, ref
    if len(slab) == 1:
        if name.endswith("interval"):
            return ops.cosine_topk_interval(q, *slab, *op, k=k)
        return ops.cosine_topk(q, *slab, op, k=k)
    if name.endswith("interval"):
        fn = (ref.quant_cosine_topk_interval_ref if plain
              else kmod.quant_cosine_topk_interval_cuda)
        return fn(q, *slab, *op, k)
    if plain:
        return ref.quant_cosine_topk_ref(q, *slab, op, k)
    return ops.quant_cosine_topk(q, *slab, op, k=k)


def phase_quant(torch, served=None) -> tuple[dict, dict]:
    """Per-row-scale int8 lookups on the slabs of the paper configuration:
    the f32 slab the main phase served (16,384 slots) and the one of
    ``--tenants 4`` (65,536), each quantized with ``quantize_keys``, every
    served batch through its kernels (``_quant_batches``), 16 launches of
    each. Each result is held against its plain version (ids equal apart
    from near-ties, which are counted, scores within 1e-5), and the rows
    whose hit decision at THRESHOLD differs from the f32 search of the same
    slab are counted, not limited: a per-row-scale slab is another slab.
    ``served`` maps "main" and "tenancy" to an (engine, requests) pair that
    served on the card; without it both are served here. Returns each
    kernel's launches and its worst score error against the plain
    version."""
    from repro_torch.kernels.cosine_topk import quantize_keys
    if served is None:
        served = {"main": _serve(torch, device="cuda")[:2],
                  "tenancy": _serve(torch, device="cuda",
                                    tenants=TENANTS)[:2]}
    tol = SCORE_TOL["quant"]
    launches, max_err = {}, {}
    for slab_name, (eng, reqs) in served.items():
        keys = eng.state.keys
        kq, sc = quantize_keys(keys)
        k = eng.cache.index.topk
        batches = _quant_batches(torch, eng, reqs, slab_name)
        _reset_launches()
        outs = [{name: _quant_search(torch, name, q, (kq, sc), op, k)
                 for name, op in operands.items()}
                for q, operands in batches]
        torch.cuda.synchronize()
        want = dict.fromkeys(batches[0][1], MAIN_BATCHES)
        _expect_launches(_launches(), want, f"quant phase, {slab_name} slab")
        launches.update(want)
        for name in want:
            err, near, flips, gap = 0.0, 0, 0, 0.0
            for (q, operands), out in zip(batches, outs):
                ks, ki = out[name]
                op = operands[name]
                rs1, ri1 = _quant_search(torch, name, q, (kq, sc), op, k + 1,
                                         plain=True)
                err = max(err, _compare(torch, ks, ki, rs1, ri1, k, tol,
                                        f"quant {name} {slab_name} slab",
                                        {}))
                near += int((ki.cpu() != ri1[:, :k].cpu()).sum())
                fs, _ = _quant_search(torch, name, q, (keys,), op, k)
                flips += int(((ks[:, 0] >= THRESHOLD)
                              != (fs[:, 0] >= THRESHOLD)).sum())
                both = torch.isfinite(ks[:, 0]) & torch.isfinite(fs[:, 0])
                gap = max(gap, float((ks[both, 0] - fs[both, 0]).abs().max())
                          if both.any() else 0.0)
            emit("quant", kernel=name, slab=slab_name, slots=keys.shape[0],
                 d=keys.shape[1], requests=len(reqs), batches=len(batches),
                 launches=want[name], max_abs_err=err, tolerance=tol,
                 ids_differing_at_near_ties=near,
                 hit_decisions_differing_from_f32=flips,
                 max_top1_diff_from_f32=gap,
                 slab_mb_f32=keys.numel() * 4 / 1e6,
                 slab_mb_int8_and_scales=(kq.numel() + sc.numel() * 4) / 1e6)
            max_err[name] = err
    return launches, max_err


# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
ASYNC_CLIENTS = 32         # launch.serve --concurrency default
ASYNC_STAGES = ("queue_wait", "batch_form", "embed", "device_step",
                "backend_call", "insert", "respond")
SPAN_SUM_RATIO = (0.9, 1.1)   # span sum vs e2e at p50 and p95
TCP_BURST = 16


def _quiet(*_a) -> None:
    pass


class _PlainOnCard:
    """Counts calls of a plain top-k with tensors on the card while it is
    active (ops dispatch sends CUDA tensors to the kernels, so it must stay
    0). A count, not a failure: the calls come from the scheduler's worker
    thread."""

    NAMES = ("cosine_topk_ref", "cosine_topk_interval_ref",
             "quant_cosine_topk_ref", "quant_cosine_topk_interval_ref",
             "ivf_topk_ref")

    def __enter__(self):
        from repro_torch.kernels import ref
        self.ref, self.saved, self.calls = ref, {}, 0
        for name in self.NAMES:
            fn = self.saved[name] = getattr(ref, name)
            setattr(ref, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def counted(*args, **kw):
            if any(getattr(a, "is_cuda", False) for a in args):
                self.calls += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ref, name, fn)


def _drive_async(eng, requests, *, coalesce=True, wave=None, rate_qps=None,
                 scrape=False):
    """Serve ``requests`` through an ``AsyncCacheServer`` at the
    ``launch.serve --scheduler async`` settings (flush at the engine's
    batch size or after 5 ms, DRR weights from the registry): lockstep
    ``wave``s, an open loop at ``rate_qps``, else ASYNC_CLIENTS closed-loop
    clients. Returns the LoadResult, the batches served and, with
    ``scrape``, the bodies of ``/metrics`` and ``/events`` read over
    loopback after the run, the server still up."""
    import asyncio
    from repro_torch.serving import (AsyncCacheServer, SchedulerConfig,
                                     run_closed_loop, run_open_loop,
                                     run_waves)
    sched = SchedulerConfig(
        max_batch=eng.batcher.batch_size, max_wait_ms=5.0, coalesce=coalesce,
        tenant_weights=None if eng.registry is None
        else eng.registry.weights())

    async def get(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        await writer.drain()
        raw = (await asyncio.wait_for(reader.read(), 60)).decode()
        writer.close()
        await writer.wait_closed()
        head, body = raw.split("\r\n\r\n", 1)
        if not head.startswith("HTTP/1.1 200"):
            fail(f"GET {path}: {head.splitlines()[0]}")
        return body

    async def drive():
        async with AsyncCacheServer(eng, sched) as server:
            port = await server.serve_metrics(port=0) if scrape else None
            submit = server.submit_request
            if wave:
                res = await run_waves(submit, requests, wave=wave)
            elif rate_qps:
                res = await run_open_loop(submit, requests, rate_qps)
            else:
                res = await run_closed_loop(submit, requests,
                                            concurrency=ASYNC_CLIENTS)
            pages = {path: await get(port, path)
                     for path in ("/metrics", "/events")} if scrape else {}
            return res, server.scheduler.batches_served, pages
    return asyncio.run(drive())


def _tcp_burst(eng, query: str) -> list:
    """TCP_BURST pipelined lines of ``query`` and one malformed line to
    ``serve_tcp`` on loopback; returns the response lines."""
    import asyncio
    from repro_torch.serving import AsyncCacheServer, SchedulerConfig

    async def client():
        sched = SchedulerConfig(max_batch=eng.batcher.batch_size,
                                max_wait_ms=5.0)
        async with AsyncCacheServer(eng, sched) as server:
            port = await server.serve_tcp("127.0.0.1", 0)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            for i in range(TCP_BURST):
                writer.write(json.dumps({"id": i, "query": query}).encode()
                             + b"\n")
            writer.write(b"not json\n")
            await writer.drain()
            lines = [json.loads(await asyncio.wait_for(reader.readline(), 60))
                     for _ in range(TCP_BURST + 1)]
            writer.close()
            await writer.wait_closed()
            return lines
    return asyncio.run(client())


def _scraped(body: str) -> tuple[set, dict]:
    """Families and unlabeled samples of one exposition."""
    fams, samples = set(), {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            fams.add(line.split()[2])
        elif line and not line.startswith("#") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return fams, samples


def _async_numbers(eng, res, batches: int, where: str) -> dict:
    """Throughput, e2e percentiles, the stage decomposition and the span
    sum against e2e over the run's traces (every request traced)."""
    from repro_torch.serving.metrics import percentiles
    traces = eng.tracer.traces()
    if len(traces) != len(res.responses):
        fail(f"{where}: {len(traces)} traces for {len(res.responses)} "
             "requests")
    e2e = percentiles([t.e2e_s for t in traces])
    sums = percentiles([t.span_sum_s for t in traces])
    decomp = eng.tracer.stage_decomposition()
    return {
        "requests": len(res.responses), "wall_s": res.wall_s,
        "sustained_qps": res.achieved_qps,
        "e2e_s": {k: e2e[k] for k in ("p50_s", "p95_s", "p99_s")},
        "stages_s": {name: {"p50": decomp[name]["p50_s"],
                            "p95": decomp[name]["p95_s"],
                            "count": decomp[name]["count"]}
                     for name in ASYNC_STAGES if name in decomp},
        "span_sum_ratio": {"p50": sums["p50_s"] / e2e["p50_s"],
                           "p95": sums["p95_s"] / e2e["p95_s"]},
        "batches": batches, "mean_rows": eng.metrics.queries / batches,
        "coalesced": eng.metrics.coalesced_calls}


def _all_answered(res, n: int, eng, where: str) -> None:
    if len(res.responses) != n or not all(
            r is not None and r.answer and not r.error
            for r in res.responses):
        fail(f"{where}: not every request was answered")
    if eng.metrics.queries + eng.metrics.coalesced_calls != n:
        fail(f"{where}: {eng.metrics.queries} queries + "
             f"{eng.metrics.coalesced_calls} coalesced != {n}")


def _traced_engine(torch, **kw):
    """A warmed engine with one warm-up batch served and its metrics reset
    (``launch.serve.warm_serve_path``), then tracing every request into a
    ring that holds them all and logging every batch."""
    from repro_torch.launch import serve
    from repro_torch.obs import EventLog, TraceConfig, Tracer
    eng, reqs = serve.build(device="cuda", log=_quiet, **kw)
    serve.warm_serve_path(eng)
    torch.cuda.synchronize()
    eng.tracer = Tracer(TraceConfig(sample_rate=1.0, head=0,
                                    max_traces=len(reqs)))
    eng.events = EventLog(capacity=len(reqs))
    return eng, reqs


def phase_serve_async(torch, sync: dict) -> dict:
    """The async front end (``launch.serve --scheduler async``) on the
    card at the main configuration: lockstep waves held against the main
    phase's sync run request by request; a traced closed loop of
    ASYNC_CLIENTS clients with its /metrics scrape; an open loop at half
    the closed loop's rate; ``--tenants 4`` closed loop and waves against
    the CPU; a TCP burst. Every engine serves one warm-up batch first."""
    from repro_torch.launch import serve
    from repro_torch.obs import REQUIRED_FAMILIES
    plain = _PlainOnCard()
    out = {}
    with plain:
        # 1. waves of 128 without coalescing against the sync card run
        eng, reqs = serve.build(device="cuda", log=_quiet)
        _reset_launches()
        before = eng.stats.host()
        serve.warm_serve_path(eng)
        warm = {k: v - before[k] for k, v in eng.stats.host().items()}
        warm_calls = eng.backend.calls
        res, batches, _ = _drive_async(eng, reqs, coalesce=False, wave=128)
        torch.cuda.synchronize()
        _expect_launches(_launches(), {"cosine_topk": MAIN_BATCHES + 1},
                         "async waves (16 batches and the warm-up)")
        if batches != MAIN_BATCHES:
            fail(f"async waves: {batches} batches, not {MAIN_BATCHES}")
        _same_decisions(res.responses, sync["responses"],
                        "async waves vs the sync card run", SCORE_TOL["f32"])
        stats = {k: v - warm[k] for k, v in eng.stats.host().items()}
        if stats != sync["stats"]:
            fail(f"async waves: counters {stats} vs sync {sync['stats']}")
        if eng.backend.calls - warm_calls != sync["calls"]:
            fail(f"async waves: {eng.backend.calls - warm_calls} backend "
                 f"calls vs sync {sync['calls']}")
        if eng.metrics.summary()["categories"] != sync["categories"]:
            fail("async waves: Table 1 differs from the sync run")
        out["waves"] = {"requests": len(res.responses), "batches": batches,
                        "wall_s": res.wall_s, "qps": res.achieved_qps}
        emit("serve_async", check="waves of 128 equal the sync card run",
             launches=_launches()["cosine_topk"], **out["waves"])

        # 5. a pipelined TCP burst of one served query, on the same slab
        lines = _tcp_burst(eng, reqs[0].query)
        answers = [ln for ln in lines if "answer" in ln]
        errors = [ln for ln in lines if "error" in ln]
        coalesced = sum(ln["coalesced"] for ln in answers)
        ids = sorted(ln["id"] for ln in answers)
        if ids != list(range(TCP_BURST)) or len(errors) != 1 \
                or not all(ln["cached"] for ln in answers) \
                or coalesced < TCP_BURST - 1:
            fail(f"TCP burst: {lines}")
        out["tcp"] = {"lines": len(lines), "coalesced": coalesced}
        emit("serve_async", check="TCP burst on loopback", **out["tcp"])
        del eng

        # 2. closed loop, coalescing on, every request traced
        eng, reqs = _traced_engine(torch)
        _reset_launches()
        res, batches, pages = _drive_async(eng, reqs, scrape=True)
        torch.cuda.synchronize()
        _expect_launches(_launches(), {"cosine_topk": batches},
                         "async closed loop (a launch a batch)")
        _all_answered(res, len(reqs), eng, "async closed loop")
        closed = _async_numbers(eng, res, batches, "async closed loop")
        for q, ratio in closed["span_sum_ratio"].items():
            if not SPAN_SUM_RATIO[0] <= ratio <= SPAN_SUM_RATIO[1]:
                fail(f"async closed loop: span sum / e2e at {q} = {ratio}")
        fams, samples = _scraped(pages["/metrics"])
        if not set(REQUIRED_FAMILIES) <= fams:
            fail(f"/metrics lacks {set(REQUIRED_FAMILIES) - fams}")
        host = eng.stats.host()
        scraped = {k: int(samples[f"repro_slab_{k}_total"])
                   for k in ("lookups", "hits", "inserts",
                             "expired_evictions")}
        if scraped != {k: host[k] for k in scraped}:
            fail(f"/metrics slab counters {scraped} vs the engine's {host}")
        if len(pages["/events"].splitlines()) != batches:
            fail("/events: not one event a batch")
        out["closed"] = closed
        emit("serve_async", check="closed loop, traced, /metrics scraped",
             clients=ASYNC_CLIENTS, **closed)

        # 3. open loop, Poisson arrivals at half the closed loop's rate
        eng, reqs = _traced_engine(torch)
        rate = closed["sustained_qps"] / 2
        _reset_launches()
        res, batches, _ = _drive_async(eng, reqs, rate_qps=rate)
        torch.cuda.synchronize()
        _expect_launches(_launches(), {"cosine_topk": batches},
                         "async open loop (a launch a batch)")
        _all_answered(res, len(reqs), eng, "async open loop")
        out["open"] = _async_numbers(eng, res, batches, "async open loop")
        emit("serve_async", check="open loop", rate_qps=rate, **out["open"])
        del eng

        # 4. four tenants: closed loop under DRR, then waves card vs CPU
        eng, reqs = _traced_engine(torch, tenants=TENANTS)
        _reset_launches()
        res, batches, _ = _drive_async(eng, reqs)
        torch.cuda.synchronize()
        _expect_launches(_launches(), {"cosine_topk_interval": batches},
                         "async four tenants (a launch a batch)")
        _all_answered(res, len(reqs), eng, "async four tenants")
        out["tenants"] = _async_numbers(eng, res, batches,
                                        "async four tenants")
        del eng
        waves = {}
        for device in ("cuda", "cpu"):
            e, r = serve.build(device=device, tenants=TENANTS, log=_quiet)
            serve.warm_serve_path(e)
            wres, _, _ = _drive_async(e, r, coalesce=False, wave=128)
            waves[device] = (wres.responses, e.tenant_stats(),
                             e.stats.host())
            del e
        _same_decisions(waves["cuda"][0], waves["cpu"][0],
                        "async four-tenant waves, card vs CPU",
                        SCORE_TOL["f32"])
        if waves["cuda"][1:] != waves["cpu"][1:]:
            fail("async four-tenant waves: per-tenant counters differ from "
                 f"the CPU: {waves['cuda'][1]} vs {waves['cpu'][1]}")
        out["tenants"]["tenant_stats"] = waves["cuda"][1]
        emit("serve_async", check="four tenants, closed loop; waves equal "
             "the CPU's per-tenant counters", **out["tenants"])
    if plain.calls:
        fail(f"a plain top-k ran {plain.calls} times on card tensors")
    return out


# --------------------------------------------------------------------- #
CTX_CORPUS = 2000          # launch.serve defaults: QA pairs a category ...
CTX_QUERIES = 500          # ... and test queries a category
CTX_GROUPS = 16            # 16 groups x 2 follow-ups: the 32-entity pool
CTX_TURNS = 3
CTX_CLIENTS = 16           # run_sessions concurrency
BAND_TOL = 1e-6            # band state, card vs CPU
CTX_HOST = ("_session_windows", "_maybe_fuse", "_canonical_keys",
            "_append_turns", "_synthesize_near",
            "_serve_degraded")                      # the slice's host work
CTX_TIMED = CTX_HOST + ("_embed",)                    # and host embedding


def _ctx_workload():
    """The main configuration's pairs and requests (``launch.serve``
    defaults), its record/replay conversations, and two judges: the main
    path's (``serve.build``'s) and one that also knows the follow-ups'
    source ids (``paper_tables.context_table``'s)."""
    from repro_torch.data.qa_dataset import build_corpus, build_test_queries
    from repro_torch.serving import Request, build_multi_turn_workload
    pairs = build_corpus(CTX_CORPUS, seed=0)
    reqs = [Request(query=q.query, category=q.category,
                    source_id=q.source_id, semantic_key=q.semantic_key)
            for q in build_test_queries(pairs, n_per_category=CTX_QUERIES,
                                        seed=1)]
    convs = build_multi_turn_workload(pairs, CTX_GROUPS, turns=CTX_TURNS,
                                      seed=23)
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    return {"pairs": pairs, "reqs": reqs, "convs": convs, "judge": judge,
            "ctx_judge": _ctx_judge(pairs, convs)}


def _ctx_judge(pairs, convs):
    """``paper_tables.context_table``'s judge: the corpus's and the
    follow-ups' semantic keys by source id."""
    key_by_sid = {p.qa_id: p.semantic_key for p in pairs}
    for conv in convs:
        for r in conv:
            key_by_sid.setdefault(r.source_id, r.semantic_key)

    def judge(req, sid):
        return key_by_sid.get(sid, "") == req.semantic_key
    return judge


def _ctx_engine(torch, wl, device, *, judge=None, backend=None, tenants=0,
                **kw):
    """A warmed engine at the main configuration (``serve.build``'s slab,
    batch, threshold and sim backend) with this slice's features in
    ``kw``; with ``tenants``, ``--tenants`` regions each warmed with the
    corpus. The slice's host helpers and the embedding are timed
    (``eng.ctx_host_s``); on the card ``_maybe_fuse`` is the host time
    of launching the pooling, not its device time."""
    from repro_torch.core.types import CacheConfig
    from repro_torch.serving import CachedEngine, SimulatedLLMBackend
    from repro_torch.tenancy import TenantRegistry
    registry = None
    if tenants:
        registry = TenantRegistry.uniform(
            [f"tenant-{i}" for i in range(tenants)])
    cfg = CacheConfig(dim=384, capacity=max(16384, 8 * CTX_CORPUS)
                      * max(1, tenants), value_len=48, threshold=THRESHOLD)
    eng = CachedEngine(cfg, backend or SimulatedLLMBackend(wl["pairs"]),
                       judge=judge or wl["judge"], batch_size=128,
                       registry=registry, device=device, **kw)
    for name in (registry.names if registry else [None]):
        eng.warm(wl["pairs"], tenant=name)
    spent = eng.ctx_host_s = dict.fromkeys(CTX_TIMED, 0.0)
    for name in CTX_TIMED:
        owner = eng.cache if name == "_maybe_fuse" else eng

        def timed(*a, _fn=getattr(owner, name), _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            spent[_name] += time.perf_counter() - t0
            return out
        object.__setattr__(owner, name, timed)    # the cache is frozen
    if device == "cuda":
        torch.cuda.synchronize()
    return eng


def _ctx_serve(torch, eng, batches, warmup=None) -> dict:
    """Serve ``batches`` (each <= 128 rows, one ``serve_batch`` each) after
    an optional warm-up request; returns the responses, the kernels'
    launches over the run, its wall and the slice's host seconds."""
    from repro_torch.serving import Request
    if warmup is not None:
        eng.serve_batch([Request(query=warmup)])
    _reset_launches()
    for k in eng.ctx_host_s:
        eng.ctx_host_s[k] = 0.0
    t0 = time.perf_counter()
    resp = []
    for b in batches:
        resp += eng.serve_batch(b)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"eng": eng, "resp": resp, "launches": _launches(),
            "batches": len(batches), "wall_s": wall,
            "wall_per_batch_s": wall / len(batches),
            "host_s": dict(eng.ctx_host_s)}


def _flags(r) -> tuple:
    return (r.cached, r.answer, r.context, r.near_hit, r.degraded,
            bool(r.error))


def _ctx_twins(torch, wl, batches, where: str, make_kw, *,
               kernel="cosine_topk", warmup=None) -> tuple[dict, dict]:
    """One engine on the card and its twin on the CPU over ``batches``,
    each built with ``make_kw()``'s features: decisions, answers and flags
    identical, scores within 1e-5, device counters and summaries equal;
    ``kernel`` launched once a batch on the card, nothing on the CPU."""
    runs = {}
    for device in ("cuda", "cpu"):
        eng = _ctx_engine(torch, wl, device, **make_kw())
        runs[device] = _ctx_serve(torch, eng, batches, warmup)
    card, cpu = runs["cuda"], runs["cpu"]
    _expect_launches(card["launches"], {kernel: card["batches"]},
                     f"{where} on the card")
    _expect_launches(cpu["launches"], {}, f"{where} on the CPU")
    for i, (x, y) in enumerate(zip(card["resp"], cpu["resp"])):
        if _flags(x) != _flags(y):
            fail(f"{where}: request {i} differs card vs CPU: {x} vs {y}")
        if not (x.score == y.score or abs(x.score - y.score) <= 1e-5):
            fail(f"{where}: request {i} score {x.score} vs {y.score}")
    ce, pe = card["eng"], cpu["eng"]
    if ce.stats.host() != pe.stats.host():
        fail(f"{where}: counters {ce.stats.host()} vs CPU {pe.stats.host()}")
    cs, ps = ce.metrics.summary(), pe.metrics.summary()
    for key in ("categories", "context", "near", "resilience"):
        if cs[key] != ps[key]:
            fail(f"{where}: summary[{key!r}] differs from the CPU")
    return card, cpu


def _ctx_numbers(run) -> dict:
    host = run["host_s"]
    return {"batches": run["batches"], "wall_s": run["wall_s"],
            "wall_per_batch_s": run["wall_per_batch_s"], "host_s": host,
            "slice_host_s_per_batch": sum(host[k] for k in CTX_HOST)
            / run["batches"],
            "embed_s_per_batch": host["_embed"] / run["batches"],
            "launches": {k: v for k, v in run["launches"].items() if v}}


def _rings_within(card_eng, cpu_eng, tol, where) -> float:
    """The session rings (canonical fused keys) card vs CPU."""
    import numpy as np
    a, b = card_eng.sessions._sessions, cpu_eng.sessions._sessions
    if list(a) != list(b):
        fail(f"{where}: the session stores differ card vs CPU")
    err = max((float(np.abs(a[k].ring - b[k].ring).max()) for k in a),
              default=0.0)
    if not err <= tol:
        fail(f"{where}: fused keys differ card vs CPU by {err}")
    return err


def _mixed_batches(wl):
    """Record then replay, turn level by turn level: each level's 16
    session rows in one batch of 128 filled with the next stateless
    requests of the main workload; the rest of it in batches of 128."""
    from repro_torch.serving import turn_levels
    convs, reqs = wl["convs"], wl["reqs"]
    levels = turn_levels(convs[:CTX_GROUPS]) + turn_levels(convs[CTX_GROUPS:])
    batches, k = [], 0
    for level in levels:
        fill = 128 - len(level)
        batches.append(list(level) + reqs[k:k + fill])
        k += fill
    batches += [reqs[i:i + 128] for i in range(k, len(reqs), 128)]
    return batches


def _session_tcp_line(eng) -> dict:
    """One TCP line with a ``session`` to ``serve_tcp`` on loopback."""
    import asyncio
    from repro_torch.serving import AsyncCacheServer, SchedulerConfig

    async def client():
        sched = SchedulerConfig(max_batch=128, max_wait_ms=5.0)
        async with AsyncCacheServer(eng, sched) as server:
            port = await server.serve_tcp("127.0.0.1", 0)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(json.dumps({"id": 1, "query": "and what about it",
                                     "session": "tcp-session"}).encode()
                         + b"\n")
            await writer.drain()
            line = json.loads(await asyncio.wait_for(reader.readline(), 60))
            writer.close()
            await writer.wait_closed()
            return line
    return asyncio.run(client())


def _sessions_async(torch, wl, device) -> dict:
    """The conversations through ``AsyncCacheServer`` by ``run_sessions``
    (CTX_CLIENTS clients): all recordings, then all replays."""
    import asyncio
    from repro_torch.context import DecayMeanFusion
    from repro_torch.serving import (AsyncCacheServer, SchedulerConfig,
                                     run_sessions)
    eng = _ctx_engine(torch, wl, device, judge=wl["ctx_judge"],
                      fusion=DecayMeanFusion(window=4))
    convs = wl["convs"]

    async def drive():
        sched = SchedulerConfig(max_batch=128, max_wait_ms=5.0)
        async with AsyncCacheServer(eng, sched) as server:
            out = []
            for part in (convs[:CTX_GROUPS], convs[CTX_GROUPS:]):
                res = await run_sessions(server.submit_request, part,
                                         concurrency=CTX_CLIENTS)
                out += res.responses
            return out, server.scheduler.batches_served
    _reset_launches()
    t0 = time.perf_counter()
    resp, batches = asyncio.run(drive())
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"eng": eng, "resp": resp, "batches": batches,
            "launches": _launches(), "wall_s": wall,
            "wall_per_batch_s": wall / batches,
            "host_s": dict(eng.ctx_host_s)}


def phase_serve_context(torch, sync: dict) -> dict:
    """Sessions, the near-hit band and resilience at the main configuration
    (``launch.serve`` defaults), each engine on the card and again on the
    CPU, compared request by request. Returns the card's launches of the
    cosine kernels over the phase."""
    import numpy as np
    from repro_torch.context import AttentionFusion, DecayMeanFusion
    from repro_torch.generative import BandPolicy, TemplateSplice
    from repro_torch.serving import (CircuitBreaker, FaultSchedule,
                                     FaultWindow, FaultyBackend,
                                     ResilienceConfig, RetryPolicy,
                                     SimulatedLLMBackend, availability,
                                     build_multi_turn_workload, turn_levels)
    wl = _ctx_workload()
    reqs = wl["reqs"]
    main_batches = [reqs[i:i + 128] for i in range(0, len(reqs), 128)]
    launches = dict.fromkeys(KERNELS, 0)

    def count(run):
        for name, n in run["launches"].items():
            launches[name] += n

    # 1a. stateless traffic through a fusion engine: the main run, bit for
    #     bit (every window is empty, so every key passes through)
    card, cpu = _ctx_twins(torch, wl, main_batches, "sessions, stateless",
                           lambda: dict(fusion=DecayMeanFusion(window=4)))
    count(card)
    for i, (x, y) in enumerate(zip(card["resp"], sync["responses"])):
        if (x.cached, x.answer, x.score) != (y.cached, y.answer, y.score) \
                or x.context:
            fail(f"sessions, stateless: request {i} differs from the main "
                 f"run: {x} vs {y}")
    if card["eng"].stats.host() != sync["stats"] or \
            card["eng"].metrics.summary()["categories"] != sync["categories"]:
        fail("sessions, stateless: counters or Table 1 differ from the "
             "main run")
    emit("serve_context", check="stateless traffic through DecayMeanFusion "
         "equals the main run bit for bit", **_ctx_numbers(card))

    # 1b. mixed traffic: the turn levels in batches filled with the main
    #     workload, fused (two strategies) and stateless
    mixed = _mixed_batches(wl)
    rates, sync_ctx = {}, None
    for tag, fusion in (("decay", DecayMeanFusion(window=4)),
                        ("attention", AttentionFusion(window=4)),
                        ("stateless", None)):
        card, cpu = _ctx_twins(torch, wl, mixed, f"sessions, {tag}",
                               lambda: dict(judge=wl["ctx_judge"],
                                            fusion=fusion))
        count(card)
        cats = card["eng"].metrics.summary()["categories"]
        rep = cats["ctx/followup_repeat"]
        rates[tag] = {"hits": rep["cache_hits"], "lookups": rep["lookups"],
                      "hit_rate": rep["hit_rate"],
                      "positive_rate": rep["positive_rate"]}
        err = None
        if fusion is not None:
            err = _rings_within(card["eng"], cpu["eng"], 1e-5,
                                f"sessions, {tag}")
        if tag == "decay":
            sync_ctx = rep["cache_hits"]
        emit("serve_context", check=f"mixed traffic, {tag}",
             followup_repeat=rates[tag], fused_key_max_err=err,
             context=card["eng"].metrics.summary()["context"],
             **_ctx_numbers(card))
        del card, cpu
    if rates["stateless"]["hits"] != 0 or not all(
            rates[t]["hits"] > 0 for t in ("decay", "attention")):
        fail(f"sessions: fused replays must hit where stateless ones do "
             f"not: {rates}")

    # 1c. the same conversations through the async front end
    runs = {d: _sessions_async(torch, wl, d) for d in ("cuda", "cpu")}
    a, b = runs["cuda"], runs["cpu"]
    _expect_launches(a["launches"], {"cosine_topk": a["batches"]},
                     "sessions, async (a launch a batch)")
    for i, (x, y) in enumerate(zip(a["resp"], b["resp"])):
        if _flags(x) != _flags(y) or (
                x.cached and abs(x.score - y.score) > 1e-5):
            fail(f"sessions, async: request {i} differs card vs CPU")
    hits = a["eng"].metrics.summary()["categories"][
        "ctx/followup_repeat"]["cache_hits"]
    if hits != sync_ctx:
        fail(f"sessions, async: {hits} follow-up replay hits, the sync "
             f"turn-level run {sync_ctx}")
    line = _session_tcp_line(a["eng"])
    if "context" not in line or "answer" not in line:
        fail(f"sessions, TCP: {line}")
    count(a)
    emit("serve_context", check="sessions through run_sessions equal the "
         "sync run's replay hits; a TCP session line", followup_repeat_hits=
         hits, tcp_line=line, **_ctx_numbers(a))
    del runs, a, b

    # 1d. sessions over four tenants (the interval kernel)
    names = [f"tenant-{i}" for i in range(TENANTS)]
    tconvs = build_multi_turn_workload(wl["pairs"], CTX_GROUPS,
                                       turns=CTX_TURNS, tenants=names,
                                       seed=23)
    levels = turn_levels(tconvs[:CTX_GROUPS]) + \
        turn_levels(tconvs[CTX_GROUPS:])
    twl = dict(wl, convs=tconvs)
    card, cpu = _ctx_twins(
        torch, twl, levels, "sessions, four tenants",
        lambda: dict(judge=_ctx_judge(wl["pairs"], tconvs), tenants=TENANTS,
                     fusion=DecayMeanFusion(window=4)),
        kernel="cosine_topk_interval")
    count(card)
    err = _rings_within(card["eng"], cpu["eng"], 1e-5,
                        "sessions, four tenants")
    rep = card["eng"].metrics.summary()["categories"]["ctx/followup_repeat"]
    if card["eng"].tenant_stats() != cpu["eng"].tenant_stats() or \
            rep["cache_hits"] == 0:
        fail(f"sessions, four tenants: {rep}")
    emit("serve_context", check="sessions over four tenants",
         followup_repeat=rep, fused_key_max_err=err, **_ctx_numbers(card))
    del card, cpu

    # 2. the near-hit band against the main run
    card, cpu = _ctx_twins(
        torch, wl, main_batches, "near-hit band",
        lambda: dict(synthesizer=TemplateSplice(rival_margin=0.12),
                     policy=BandPolicy(tau_lo=0.75, tau_hi=0.8)))
    count(card)
    for i, (x, y) in enumerate(zip(card["resp"], sync["responses"])):
        if y.cached and (x.answer, x.score, x.cached) != \
                (y.answer, y.score, y.cached):
            fail(f"near-hit band: exact row {i} differs from the main run: "
                 f"{x} vs {y}")
    ce, pe = card["eng"], cpu["eng"]
    band = np.abs(ce.policy_state.cpu().numpy()
                  - pe.policy_state.numpy()).max()
    if not band <= BAND_TOL:
        fail(f"near-hit band: band state card vs CPU differs by {band}")
    near = ce.metrics.summary()["near"]
    emit("serve_context", check="near-hit band; exact rows equal the main "
         "run", near=near, backend_calls=ce.backend.calls,
         backend_calls_saved=sync["calls"] - ce.backend.calls,
         band_state=ce.policy_state.cpu().tolist(), band_state_err=float(
             band), **_ctx_numbers(card))
    del card, cpu, ce, pe

    # 3. resilience behind the fault schedule of paper_tables'
    #    resilience_table, then with an empty schedule
    def schedule():
        return FaultSchedule(windows=(
            FaultWindow("error", 2, 7),
            FaultWindow("brownout", 8, 11, error_rate=0.5),
            FaultWindow("latency_spike", 11, 13, extra_latency_s=0.02),
        ), seed=5)

    def config():
        return ResilienceConfig(
            retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                              max_backoff_s=0.002, seed=3),
            breaker=CircuitBreaker(failure_threshold=3, window=8,
                                   cooldown_s=0.0),
            sleep=lambda s: None)

    avail = {}
    for tag, on in (("off", False), ("on", True)):
        card, cpu = _ctx_twins(
            torch, wl, main_batches, f"resilience {tag}",
            lambda: dict(backend=FaultyBackend(
                SimulatedLLMBackend(wl["pairs"]), schedule()),
                policy=BandPolicy(0.70, 0.80, degraded_lo=0.60),
                resilience=config() if on else None),
            warmup="resilience warmup")
        count(card)
        ce = card["eng"]
        avail[tag] = availability(card["resp"])
        br = ce.resilience.breaker if ce.resilience else None
        emit("serve_context", check=f"resilience {tag}",
             availability=avail[tag],
             faults_injected=ce.backend.faults_injected,
             degraded=sum(r.degraded for r in card["resp"]),
             errors=sum(bool(r.error) for r in card["resp"]),
             resilience=ce.metrics.summary()["resilience"],
             breaker=None if br is None else {
                 "trips": br.trips, "recoveries": br.recoveries,
                 "short_circuits": br.short_circuits, "state": br.state},
             **_ctx_numbers(card))
        del card, cpu, ce
    if not avail["on"] > avail["off"]:
        fail(f"resilience: availability on {avail['on']} is not above off "
             f"{avail['off']}")
    card, cpu = _ctx_twins(
        torch, wl, main_batches, "resilience, no faults",
        lambda: dict(backend=FaultyBackend(SimulatedLLMBackend(wl["pairs"]),
                                           FaultSchedule()),
                     resilience=config()))
    count(card)
    for i, (x, y) in enumerate(zip(card["resp"], sync["responses"])):
        if _flags(x) != _flags(y) or x.score != y.score:
            fail(f"resilience, no faults: request {i} differs from the main "
                 f"run: {x} vs {y}")
    if card["eng"].stats.host() != sync["stats"]:
        fail("resilience, no faults: counters differ from the main run")
    emit("serve_context", check="resilience on, no faults: the main run "
         "byte for byte", **_ctx_numbers(card))
    return launches


# --------------------------------------------------------------------- #
SHARDS = 4                 # serve_sharded: make_mesh((4,), ("data",))
FAIL_WITHIN_S = 10.0       # a failed shard body must fail its call by then
# serve_sharded over distinct devices with one card: shards 0 and 2 on the
# card, 1 and 3 on the CPU (``launch.serve --shards cuda:0,cpu,cuda:0,cpu``)
MIXED = ["cuda:0", "cpu", "cuda:0", "cpu"]


class _HostTime:
    """Host seconds spent in ``cls.lookup`` and ``cls.step`` while entered
    (they return before the card finishes their work), per call, and each
    step's result."""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        self.saved = {n: getattr(self.cls, n) for n in ("lookup", "step")}
        self.calls = {n: [] for n in self.saved}
        self.results = []
        for name, fn in self.saved.items():
            setattr(self.cls, name, self._wrap(fn, name))
        return self

    def _wrap(self, fn, name):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.calls[name].append(time.perf_counter() - t0)
            if name == "step":
                self.results.append(out[0])
            return out
        return timed

    @property
    def seconds(self) -> float:
        return sum(sum(v) for v in self.calls.values())

    def medians_ms(self) -> dict:
        return {n: 1e3 * sorted(v)[len(v) // 2]
                for n, v in self.calls.items()}

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def _key_multiset(eng) -> list:
    st = eng.state
    return sorted(r.tobytes() for r in st.keys[st.valid].cpu().numpy())


def _per_shard(eng, where: str) -> list:
    """Entries per shard; each must hold ceil(n / S) or floor(n / S)."""
    per = eng.state.valid.reshape(SHARDS, -1).sum(1).tolist()
    n = sum(per)
    if any(x not in (n // SHARDS, -(-n // SHARDS)) for x in per):
        fail(f"{where}: entries per shard {per} are not balanced")
    return per


def _bare_engine(like, shards: int):
    """An engine of ``like``'s configuration and empty slab, sharing its
    backend, judge and tokenizer (a snapshot carries no vocabulary, so a
    restored answer decodes to the same words only through it)."""
    from repro_torch.core import make_mesh
    from repro_torch.serving import CachedEngine
    eng = CachedEngine(
        like.cache.config, like.backend, judge=like.judge,
        batch_size=like.batcher.batch_size, device="cuda",
        mesh=make_mesh((shards,), ("data",)) if shards else None)
    eng.tokenizer = like.tokenizer
    return eng


def _sharded_recall(eng, reqs) -> dict:
    """recall@1 of the sharded IVF lookup against the sharded exact lookup
    on the warm slab after the refit: the IVF top-1 scores what the exact
    top-1 scores, within 1e-6."""
    from repro_torch.core import DistributedCache, SemanticCache
    from repro_torch.core.index import ExactState
    from repro_torch.core.runtime import ShardedRuntime
    exact = DistributedCache(SemanticCache(eng.cache.config), eng.cache.mesh)
    rt = ShardedRuntime(tuple(s.replace(index_state=ExactState())
                              for s in eng.runtime.shards))
    same = 0
    for i in range(0, len(reqs), 128):
        q = eng._embed([r.query for r in reqs[i:i + 128]])
        iv, _ = eng.cache.lookup(eng.runtime, q, eng._now,
                                 update_counters=False)
        ex, _ = exact.lookup(rt, q, eng._now, update_counters=False)
        same += int(((iv.score - ex.score).abs() <= 1e-6).sum())
    return {"recall_at_1_vs_sharded_exact": same / len(reqs)}


def _failing_shard(torch, eng, batch) -> dict:
    """One shard body raises inside its search (shard 2, told by its slab
    keys' storage); ``serve_batch`` must raise within FAIL_WITHIN_S and the
    next call must serve the batch."""
    import os
    import threading
    from repro_torch.core import index as index_mod
    ops, search = index_mod.ops, index_mod.ops.cosine_topk
    target = eng.runtime.shards[2].state.keys.data_ptr()

    def flaky(q, keys, alive, *, k):
        if keys.data_ptr() == target:
            raise RuntimeError("injected failure of shard 2's search")
        return search(q, keys, alive, k=k)
    caught = []

    def call():
        try:
            eng.serve_batch(batch)
        except RuntimeError as exc:
            caught.append(exc)
    ops.cosine_topk = flaky
    try:
        t0 = time.perf_counter()
        th = threading.Thread(target=call, daemon=True)
        th.start()
        th.join(timeout=120)
        raised_s = time.perf_counter() - t0
    finally:
        ops.cosine_topk = search
    if th.is_alive():
        print("chip_smoke: FAIL: a failed shard body hung its call",
              file=sys.stderr, flush=True)
        os._exit(1)          # the hung shard threads would block exit
    if len(caught) != 1 or "injected" not in str(caught[0]):
        fail(f"failing shard: the call did not raise the shard's error "
             f"({caught})")
    if raised_s > FAIL_WITHIN_S:
        fail(f"failing shard: the call raised after {raised_s:.1f} s")
    resp = eng.serve_batch(batch)
    torch.cuda.synchronize()
    if len(resp) != len(batch) or not all(math.isfinite(r.score)
                                          for r in resp):
        fail("failing shard: the next call did not serve its batch")
    return {"raised_after_s": raised_s, "next_call_served": len(resp)}


def _hits_by_device(eng, results) -> dict:
    """Hits of the step results, by the device type of the shard that
    served them (global slot // local capacity)."""
    lc = eng.cache.local_capacity
    out = {"cuda": 0, "cpu": 0}
    for r in results:
        shard = (r.index[r.hit] // lc).tolist()
        for i in shard:
            out[eng.cache.devices[i].type] += 1
    return out


def _on_their_devices(eng, where: str) -> None:
    """Every shard's slab, index, tenancy and replicated leaves sit on its
    mesh device."""
    import dataclasses
    for i, (shard, dev) in enumerate(zip(eng.runtime.shards,
                                         eng.cache.devices)):
        for group in (shard.state, shard.stats, shard.index_state,
                      shard.tenancy, shard.fusion):
            if group is None:
                continue
            for f in dataclasses.fields(group):
                if getattr(group, f.name).device.type != dev.type:
                    fail(f"{where}: shard {i}'s {f.name} is not on {dev}")


# keys a CPU shard normalized against the card's, slot by slot: the norm's
# sum runs in another order (f32: last bits); an int8 key may round to the
# next step
SLAB_KEY_TOL = {"float32": 1e-6, "int8": 1.0}


def _same_slab(torch, a, b, where: str) -> float:
    """Two engines' slabs of one layout, slot by slot: validity, values,
    lengths, provenance, times and counters exactly, keys within
    SLAB_KEY_TOL. Returns the keys' largest difference."""
    sa, sb = a.state, b.state
    for name in ("valid", "values", "value_lens", "source_id", "expiry",
                 "freq", "last_used", "inserted_at", "n_inserts"):
        if not torch.equal(getattr(sa, name), getattr(sb, name)):
            fail(f"{where}: the slabs' {name} differ slot by slot")
    err = float((sa.keys.float() - sb.keys.float()).abs().max())
    tol = SLAB_KEY_TOL[str(sa.keys.dtype).split(".")[-1]]
    if sa.keys.dtype != sb.keys.dtype or err > tol:
        fail(f"{where}: keys differ by {err} slot by slot (tolerance {tol})")
    return err


def _mixed_serve(torch, devices, where: str, **kw):
    """``launch.serve --shards`` over ``devices``: the engine, requests,
    responses, launches, wall time, host-timed calls and hits by device."""
    from repro_torch.core import DistributedCache
    with _HostTime(DistributedCache) as h:
        eng, reqs, resp, launches, wall = _serve(torch, device="cuda",
                                                 shards=devices, **kw)
    _on_their_devices(eng, where)
    return eng, reqs, resp, launches, wall, h


def _mixed_main(torch, kd: str, one, four, r1, r4, scratch: Path) -> dict:
    """The main configuration on four shards over MIXED against the
    one-device four-shard run and the unsharded one: decisions, answers,
    scores, Table 1 and counters; the slab slot by slot against the
    one-device run's (same layout; that run's key multiset equals the
    unsharded one's bit for bit); a hit from a shard of each device type;
    the snapshot restored into four shards of the card and into one. Over
    every card too where there are several."""
    where = f"mixed main {kd}"
    cuda_shards = sum(d.startswith("cuda") for d in MIXED)
    mixed, reqs, rm, lm, wm, h = _mixed_serve(torch, MIXED, where,
                                              key_dtype=kd)
    _expect_launches(lm, {"cosine_topk": cuda_shards * MAIN_BATCHES}, where)
    for other, resp, name in ((four, r4, "one-device four shards"),
                              (one, r1, "unsharded")):
        _same_decisions(rm, resp, f"{where} vs {name}", SCORE_TOL[kd])
        if mixed.metrics.summary()["categories"] != \
                other.metrics.summary()["categories"]:
            fail(f"{where}: Table 1 differs from the {name} run")
        if mixed.stats.host() != other.stats.host():
            fail(f"{where}: counters differ from the {name} run")
    key_err = _same_slab(torch, mixed, four, where)
    hits = _hits_by_device(mixed, h.results)
    if min(hits.values()) < 1:
        fail(f"{where}: hits by shard device {hits}: none from one type")
    out = {"devices": MIXED, "hits_by_device": hits,
           "slab_key_max_abs_diff_vs_one_device": key_err,
           "step_host_ms_per_batch": 1e3 * h.seconds / MAIN_BATCHES,
           "call_host_ms_median": h.medians_ms(),
           "wall_per_batch_s": wm / MAIN_BATCHES,
           "entries_per_shard": _per_shard(mixed, where),
           "launches_per_lookup": lm["cosine_topk"] / MAIN_BATCHES}
    if kd == "f32":
        snap = str(scratch / "mixed")
        mixed.save_cache(snap)
        follow = mixed.process(reqs)
        restored = {}
        for shards in (SHARDS, 0):
            eng = _bare_engine(mixed, shards)
            eng.load_cache(snap)
            _same_decisions(eng.process(reqs), follow,
                            f"{where}: restored into {shards or 1} shard(s)",
                            SCORE_TOL[kd])
            restored[f"into_{shards or 1}_shards"] = "same decisions"
        out["snapshot"] = restored
        n = torch.cuda.device_count()
        if n > 1:
            cards = [f"cuda:{i % n}" for i in range(SHARDS)]
            every, _, re_, le, we, he = _mixed_serve(
                torch, cards, "every card", key_dtype=kd)
            _same_decisions(re_, r4, "every card vs one device",
                            SCORE_TOL[kd])
            if every.stats.host() != four.stats.host():
                fail("every card: counters differ from one device")
            out["every_card"] = {"devices": cards,
                                 "wall_per_batch_s": we / MAIN_BATCHES,
                                 "step_host_ms_per_batch":
                                 1e3 * he.seconds / MAIN_BATCHES}
    emit("serve_sharded", check=f"main {kd} on four shards over {MIXED} "
         "equals one device and the unsharded run", requests=len(rm),
         kernel_launches=lm, **out)
    return out


def _mixed_tenants(torch, one_t, four_t, rt1, rt4) -> dict:
    """``--tenants 4`` on four shards over MIXED against the one-device
    and the unsharded runs: decisions, answers, scores, the per-tenant
    counters and summary; the slab slot by slot against the one-device
    run's."""
    where = "mixed --tenants 4"
    cuda_shards = sum(d.startswith("cuda") for d in MIXED)
    mixed, _, rm, lm, wm, h = _mixed_serve(torch, MIXED, where,
                                           tenants=TENANTS)
    _expect_launches(lm, {"cosine_topk_interval":
                          cuda_shards * MAIN_BATCHES}, where)
    for other, resp, name in ((four_t, rt4, "one-device four shards"),
                              (one_t, rt1, "unsharded")):
        _same_decisions(rm, resp, f"{where} vs {name}", 1e-5)
        if mixed.tenant_stats() != other.tenant_stats():
            fail(f"{where}: per-tenant counters differ from the {name} run")
        if _untimed_tenants(mixed.metrics.summary()) != \
                _untimed_tenants(other.metrics.summary()):
            fail(f"{where}: per-tenant summary differs from the {name} run")
    key_err = _same_slab(torch, mixed, four_t, where)
    hits = _hits_by_device(mixed, h.results)
    if min(hits.values()) < 1:
        fail(f"{where}: hits by shard device {hits}: none from one type")
    out = {"hits_by_device": hits,
           "slab_key_max_abs_diff_vs_one_device": key_err,
           "step_host_ms_per_batch": 1e3 * h.seconds / MAIN_BATCHES,
           "wall_per_batch_s": wm / MAIN_BATCHES}
    emit("serve_sharded", check=f"--tenants 4 on four shards over {MIXED} "
         "equals one device and the unsharded run", requests=len(rm),
         kernel_launches=lm, **out)
    return out


def _mixed_ivf(torch, four_i, iresp, scratch: Path) -> dict:
    """``--index ivf`` on four shards over MIXED: against four shards of
    the card restored from its post-refit snapshot (the refit's k-means
    ran on each shard's device, so a CPU shard's table may differ from the
    card's), and against the one-device IVF run where every shard's
    bucket table came out the same."""
    from repro_torch.core import make_mesh
    from repro_torch.serving import CachedEngine
    where = "mixed --index ivf"
    snap = str(scratch / "mixed-ivf")
    mixed, reqs, mresp, _, lm, wm, _ = _ivf_run(
        torch, "cuda", snapshot=snap, key_dtype="f32", shards=MIXED)
    _on_their_devices(mixed, where)
    cuda_shards = sum(d.startswith("cuda") for d in MIXED)
    _expect_launches(lm, {"cosine_topk": cuda_shards * MAIN_BATCHES,
                          "ivf_topk": cuda_shards * MAIN_BATCHES}, where)
    card = CachedEngine(mixed.cache.config, mixed.backend, judge=mixed.judge,
                        batch_size=mixed.batcher.batch_size,
                        index=mixed.cache.index, device="cuda",
                        mesh=make_mesh((SHARDS,), ("data",)))
    card.tokenizer = mixed.tokenizer
    card.load_cache(snap, reshard=False)
    _same_decisions(mresp, card.process(reqs),
                    f"{where} vs its snapshot on one card", 1e-5)
    same_tables = bool(torch.equal(mixed.runtime.index_state.buckets,
                                   four_i.runtime.index_state.buckets))
    if same_tables:
        _same_decisions(mresp, iresp, f"{where} vs one device", 1e-5)
    out = {"wall_per_batch_s": wm / MAIN_BATCHES,
           "bucket_tables_as_one_device": same_tables,
           "hits": sum(r.cached for r in mresp)}
    emit("serve_sharded", check=f"--index ivf on four shards over {MIXED} "
         "equals four card shards restored from its snapshot", **out)
    return out


def phase_serve_sharded(torch, card: str, sync: dict, scratch: Path
                        ) -> dict:
    """The sharded cache (``CachedEngine(mesh=make_mesh((4,), ("data",)))``,
    ``launch.serve --shards 4``) on the card: the main configuration in f32
    and int8 against the unsharded run, ``--tenants 4`` and ``--index ivf``
    with four shards, reshard on load 1 -> 4 -> 1, async waves, and a
    failing shard body. Returns the cosine and IVF kernels' launches over
    the phase's sharded runs."""
    from repro_torch.core import DistributedCache, SemanticCache
    from repro_torch.launch import serve
    launches = dict.fromkeys(KERNELS, 0)

    def count(run: dict) -> None:
        for name, n in run.items():
            launches[name] += n
    want = SHARDS * MAIN_BATCHES
    line = {"card": card, "shards": SHARDS}
    kept = {}

    # 1. the main configuration, unsharded and on four shards
    for kd in ("f32", "int8"):
        with _HostTime(SemanticCache) as h1:
            one, reqs, r1, _, w1 = _serve(torch, device="cuda", key_dtype=kd)
        with _HostTime(DistributedCache) as h4:
            four, _, r4, l4, w4 = _serve(torch, device="cuda", key_dtype=kd,
                                         shards=SHARDS)
        _expect_launches(l4, {"cosine_topk": want}, f"sharded main ({kd})")
        count(l4)
        where = f"sharded main {kd}"
        _same_decisions(r4, r1, f"{where} vs unsharded", SCORE_TOL[kd])
        if kd == "f32":
            _same_decisions(r4, sync["responses"],
                            f"{where} vs the main phase", SCORE_TOL[kd])
        if four.metrics.summary()["categories"] != \
                one.metrics.summary()["categories"]:
            fail(f"{where}: Table 1 differs from the unsharded run")
        if four.stats.host() != one.stats.host():
            fail(f"{where}: counters differ from the unsharded run")
        if _key_multiset(four) != _key_multiset(one):
            fail(f"{where}: the slabs hold different keys")
        per = _per_shard(four, where)
        lc = four.cache.local_capacity
        hits = sum(int(r.hit.sum()) for r in h4.results)
        cross = sum(int((r.hit & (r.index // lc != 0)).sum())
                    for r in h4.results)
        if cross < 1:
            fail(f"{where}: no hit was served from a shard other than 0")
        line[kd] = {
            "wall_per_batch_s": w4 / MAIN_BATCHES,
            "unsharded_wall_per_batch_s": w1 / MAIN_BATCHES,
            "serve_path_ms_per_batch":
            1e3 * four.metrics.cache_path_time_s / MAIN_BATCHES,
            "unsharded_serve_path_ms_per_batch":
            1e3 * one.metrics.cache_path_time_s / MAIN_BATCHES,
            "step_host_ms_per_batch": 1e3 * h4.seconds / MAIN_BATCHES,
            "unsharded_step_host_ms_per_batch":
            1e3 * h1.seconds / MAIN_BATCHES,
            "call_host_ms_median": h4.medians_ms(),
            "unsharded_call_host_ms_median": h1.medians_ms(),
            "hits": hits, "cross_shard_hits": cross,
            "entries_per_shard": per,
            "launches_per_lookup": l4["cosine_topk"] / MAIN_BATCHES}
        emit("serve_sharded", check=f"main {kd}: four shards equal the "
             "unsharded run", requests=len(r4), kernel_launches=l4,
             **line[kd])
        line[f"mixed_{kd}"] = _mixed_main(torch, kd, one, four, r1, r4,
                                          scratch)
        if kd == "f32":
            kept = {"one": one, "four": four, "reqs": reqs, "resp": r4}

    # 2. --tenants 4 on four shards
    one_t, _, rt1, _, _ = _serve(torch, device="cuda", tenants=TENANTS)
    four_t, treqs, rt4, lt4, wt4 = _serve(torch, device="cuda",
                                          tenants=TENANTS, shards=SHARDS)
    _expect_launches(lt4, {"cosine_topk_interval": want},
                     "sharded --tenants 4")
    count(lt4)
    flips = [i for i, (x, y) in enumerate(zip(rt4, rt1))
             if x.cached != y.cached or not abs(x.score - y.score) <= 1e-5]
    if len(rt4) != len(rt1) or flips:
        fail(f"sharded --tenants 4: decisions differ at {flips[:8]}")
    if four_t.tenant_stats() != one_t.tenant_stats():
        fail("sharded --tenants 4: per-tenant counters differ")
    if _untimed_tenants(four_t.metrics.summary()) != \
            _untimed_tenants(one_t.metrics.summary()):
        fail("sharded --tenants 4: per-tenant summary differs")
    line["mixed_tenancy"] = _mixed_tenants(torch, one_t, four_t, rt1, rt4)
    line["tenancy"] = {
        "wall_per_batch_s": wt4 / MAIN_BATCHES,
        "answers_differing": sum(x.answer != y.answer
                                 for x, y in zip(rt4, rt1)),
        "entries_per_shard": four_t.state.valid.reshape(
            SHARDS, -1).sum(1).tolist(),
        "launches_per_lookup": lt4["cosine_topk_interval"] / MAIN_BATCHES}
    emit("serve_sharded", check="--tenants 4 on four shards: decisions and "
         "per-tenant counters equal the unsharded run", requests=len(rt4),
         kernel_launches=lt4, **line["tenancy"])
    del one_t, four_t

    # 3. --index ivf on four shards, against a CPU engine restored from the
    #    card's post-refit snapshot
    snap = str(scratch / "sharded-ivf")
    eng_i, _, iresp, _, li, wi, recall = _ivf_run(
        torch, "cuda", snapshot=snap, on_warm_slab=_sharded_recall,
        key_dtype="f32", shards=SHARDS)
    _expect_launches(li, {"cosine_topk": want, "ivf_topk": want},
                     "sharded --index ivf")
    count(li)
    cpu_i, creqs = serve.build(device="cpu", index="ivf", shards=SHARDS,
                               log=_quiet)
    cpu_i.load_cache(snap)
    _same_decisions(iresp, cpu_i.process(creqs),
                    "sharded ivf cuda vs restored cpu", 1e-5)
    if _decisions(eng_i) != _decisions(cpu_i):
        fail("sharded ivf: per-category hits differ from the restored CPU")
    line["mixed_ivf"] = _mixed_ivf(torch, eng_i, iresp, scratch)
    line["ivf"] = {
        "wall_per_batch_s": wi / MAIN_BATCHES, **recall,
        "requests_as_sharded_exact": sum(
            x.cached == y.cached and x.answer == y.answer
            for x, y in zip(iresp, kept["resp"])),
        "launches_per_lookup": {n: li[n] / MAIN_BATCHES
                                for n in ("cosine_topk", "ivf_topk")}}
    emit("serve_sharded", check="--index ivf on four shards equals a CPU "
         "engine restored from the card's snapshot", requests=len(iresp),
         kernel_launches=li, **line["ivf"])
    del eng_i, cpu_i

    # 4. reshard on load: the unsharded f32 engine after its run -> 4 -> 1
    one, reqs = kept["one"], kept["reqs"]
    reshard = {}
    src = str(scratch / "unsharded")
    one.save_cache(src)
    for step, shards in (("1->4", SHARDS), ("4->1", 0)):
        eng = _bare_engine(one, shards)
        try:
            eng.load_cache(src, reshard=False)
            fail(f"reshard {step}: a strict load was accepted")
        except ValueError:
            pass
        eng.load_cache(src)
        filled = eng.state.valid.reshape(SHARDS, -1).sum(1).tolist()
        if shards and not all(filled):
            fail(f"reshard {step}: a shard holds no entry ({filled})")
        want_resp = one.process(reqs)        # the unsharded engine again
        _reset_launches()
        got = eng.process(reqs)
        torch.cuda.synchronize()
        if shards:
            _expect_launches(_launches(), {"cosine_topk": want},
                             f"reshard {step}")
            count(_launches())
        _same_decisions(got, want_resp, f"reshard {step} vs unsharded",
                        1e-5)
        reshard[step] = {"entries_per_shard": filled,
                         "hits": sum(r.cached for r in got)}
        src = str(scratch / f"resharded-{shards}")
        eng.save_cache(src)
    line["reshard"] = reshard
    emit("serve_sharded", check="reshard on load 1 -> 4 -> 1: strict loads "
         "refused, the unsharded engine's decisions", **reshard)

    # 5. async waves over a sharded engine against the sync sharded run
    aeng, areqs = serve.build(device="cuda", shards=SHARDS, log=_quiet)
    _reset_launches()
    res, batches, _ = _drive_async(aeng, areqs, coalesce=False, wave=128)
    torch.cuda.synchronize()
    _expect_launches(_launches(), {"cosine_topk": want}, "sharded waves")
    count(_launches())
    _same_decisions(res.responses, kept["resp"],
                    "sharded async waves vs the sync sharded run",
                    SCORE_TOL["f32"])
    if aeng.stats.host() != kept["four"].stats.host() or \
            aeng.metrics.summary()["categories"] != \
            kept["four"].metrics.summary()["categories"]:
        fail("sharded async waves: counters or Table 1 differ from sync")
    line["async_waves"] = {"batches": batches, "wall_s": res.wall_s,
                           "qps": res.achieved_qps}
    emit("serve_sharded", check="async waves of 128 on four shards equal "
         "the sync sharded run", **line["async_waves"])
    del aeng

    # 6. a failing shard body fails its call, and the next call works
    line["failing_shard"] = _failing_shard(torch, kept["four"],
                                           reqs[:128])
    emit("serve_sharded", check="a failing shard body fails the call",
         **line["failing_shard"])
    emit("serve_sharded", summary=True, **line)
    return launches


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


def _time_graph(torch, fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, so no host work (argument
    checks, allocation, the ctypes call) sits between the launches. For
    kernels shorter than the wrapper's host time, where ``_time`` reads the
    host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def _bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS
           ) -> dict:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _timing_slab(torch, gen, n, d, dtype):
    """(slab operands, the kernels' name prefix, bytes read per visible
    slot): ``dtype="quant"`` gives int8 keys and per-row scales from
    ``quantize_keys``, 4 more bytes a slot."""
    from repro_torch.kernels.cosine_topk import quantize_keys
    if dtype == "quant":
        return quantize_keys(_make_keys(torch, gen, n, d, "f32")), \
            "quant_", d + 4
    keys = _make_keys(torch, gen, n, d, dtype)
    return (keys,), "", d * keys.element_size()


def phase_timing(torch, card: str) -> dict:
    from repro_torch.core.similarity import interval_visibility
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    out = {}
    b, d, k = 128, 384, 4
    neg = torch.tensor(float("-inf"), device="cuda")
    # "quant": int8 keys with per-row scales through the quant_* kernels
    for n, dtype in ((16384, "f32"), (16384, "int8"), (16384, "quant"),
                     (1048576, "f32"), (1048576, "int8"),
                     (1048576, "quant")):
        gen = torch.Generator(device="cuda").manual_seed(7)
        slab, prefix, slot_bytes = _timing_slab(torch, gen, n, d, dtype)
        name = f"{prefix}cosine_topk"
        q = torch.randn((b, d), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9

        def kernel():
            return getattr(kmod, f"{name}_cuda")(q, *slab, valid, k)

        def plain():
            return getattr(ref, f"{name}_ref")(q, *slab, valid, k)

        def library():
            return torch.topk(torch.where(valid, q @ _as_f32(torch, *slab).T,
                                          neg), k)

        keys_f32 = _as_f32(torch, *slab)

        def gemm():
            return q @ keys_f32.T

        reps = 200 if n <= 16384 else 10
        ms, times = _time_turns(torch, {"kernel": kernel, "plain": plain,
                                        "library": library}, reps)
        # the tensor-core form's products: a_lo b_hi + a_hi b_lo + a_hi b_hi
        # for f32 keys, two for int8 keys (exact; scaled after the sum)
        nbytes = b * d * 4 + n * slot_bytes + n + b * k * 8
        products = 3 if dtype == "f32" else 2
        bound = _bound(products * 2.0 * b * n * d, nbytes, PEAK_TF32_FLOPS)
        fma = _bound(2.0 * b * n * d, nbytes)
        graph_ms = _time_graph(torch, kernel, reps)
        row = {"kernel_ms": ms["kernel"], "graph_ms": graph_ms,
               "plain_ms": ms["plain"], "library_ms": ms["library"],
               "gemm_ms": _time_graph(torch, gemm, reps), "runs_ms": times,
               **bound, "tf32_products": products,
               "bound_fma_ms": fma["bound_ms"],
               "bound_fma_by": fma["bound_by"],
               "share_of_bound": bound["bound_ms"] / graph_ms,
               "split": kmod.split(b, n, torch.cuda.get_device_properties(0)
                                   .multi_processor_count, shared=True),
               "l2_warm": n * slot_bytes < 50e6}
        out[(name, n, dtype)] = row
        emit("timing", kernel=name, B=b, N=n, d=d, k=k,
             key_dtype=dtype, card=card, **row)

    # the per-row kernels at the tenancy path's shape (4 regions of 16,384)
    # and at N = 1,048,576 (4 regions of 262,144): each row sees one region
    for n, dtype in ((65536, "f32"), (65536, "int8"), (65536, "quant"),
                     (1048576, "f32"), (1048576, "int8"),
                     (1048576, "quant")):
        gen = torch.Generator(device="cuda").manual_seed(11)
        slab, prefix, slot_bytes = _timing_slab(torch, gen, n, d, dtype)
        keys, scales = slab[0], (slab[1] if len(slab) == 2 else None)
        q = torch.randn((b, d), generator=gen, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
        valid = torch.rand(n, generator=gen, device="cuda") < 0.9
        size = n // TENANTS
        starts = (torch.arange(b, device="cuda") % TENANTS
                  * size).to(torch.int32)
        sizes = torch.full((b,), size, dtype=torch.int32, device="cuda")
        mask = interval_visibility(valid, starts, sizes)
        reps = 100 if n <= 65536 else 10
        # visible work only: each row scores its own region; the slab
        # bytes are those of the union of the intervals (here all of N)
        union = int(interval_visibility(
            torch.ones(n, dtype=torch.bool, device="cuda"), starts,
            sizes).any(0).sum())
        visible = int(sizes.long().sum())
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        # the rows sorted by region: each must get the same top-k, bit for
        # bit, as in the given (round-robin) order
        perm = torch.argsort(starts.long() * (1 << 32) + sizes.long(),
                             stable=True)

        # the interval form: what the wrapper launches is the row order on
        # the card, then the kernel; the plan's counts are read back once,
        # here
        name = f"{prefix}cosine_topk_interval"
        _, groups, span = kmod.interval_plan(q, keys, valid, starts, sizes,
                                             k, scales)

        def kernel():
            order = kmod.interval_order(starts, sizes)
            return kmod._launch(name, q, keys, (valid, starts, sizes, order),
                                k, scales, intervals=(groups, span))

        def wrapper():
            return getattr(kmod, f"{name}_cuda")(q, *slab, valid, starts,
                                                 sizes, k)

        def plain():
            return getattr(ref, f"{prefix}cosine_topk_interval_ref")(
                q, *slab, valid, starts, sizes, k)

        def library():
            cols = torch.arange(n, device="cuda")[None, :]
            inside = (cols >= starts[:, None]) & \
                (cols < (starts + sizes)[:, None])
            return torch.topk(torch.where(
                valid[None] & inside, q @ _as_f32(torch, *slab).T, neg), k)
        nbytes = b * d * 4 + union * (slot_bytes + 1) + 2 * b * 4 + b * k * 8
        row = _per_row_timing(torch, {"kernel": kernel, "wrapper": wrapper,
                                      "plain": plain, "library": library},
                              reps, 2.0 * d * visible, nbytes,
                              n * slot_bytes, dtype)
        row["split"] = dict(zip(SPLIT_KEYS, kmod.split(b, n, sms, groups,
                                                        span)))
        _same_for_sorted_rows(torch, wrapper, perm, lambda pm: getattr(
            kmod, f"{name}_cuda")(q[pm].contiguous(), *slab, valid,
                                  starts[pm].contiguous(),
                                  sizes[pm].contiguous(), k), name)
        out[(name, n, dtype)] = row
        emit("timing", kernel=name, B=b, N=n, d=d, k=k, key_dtype=dtype,
             regions=TENANTS, card=card, **row)

        # the dense form at the same visibility and, at N = 65,536, where
        # each row sees an independent random 80% of N (no tile to skip)
        name = f"{prefix}cosine_topk_masked"
        layouts = {"regions": mask}
        if n == 65536:
            layouts["unstructured"] = torch.rand(
                (b, n), generator=gen, device="cuda") < 0.8
        for layout, dense in layouts.items():
            row = _dense_timing(torch, name, prefix, q, slab, dense, k, reps,
                                slot_bytes, sms, dtype)
            _same_for_sorted_rows(
                torch, lambda: getattr(kmod, f"{name}_cuda")(q, *slab, dense,
                                                             k),
                perm, lambda pm: getattr(kmod, f"{name}_cuda")(
                    q[pm].contiguous(), *slab, dense[pm].contiguous(), k),
                name)
            out[(name, n, dtype) if layout == "regions"
                else (name, n, dtype, layout)] = row
            emit("timing", kernel=name, B=b, N=n, d=d, k=k, key_dtype=dtype,
                 regions=TENANTS, mask=layout, card=card, **row)

    out.update(_probe_timing(torch, card))
    out.update(_ivf_timing(torch, card))
    return out


SPLIT_KEYS = ("keys_per_chunk", "chunks", "block_q")


def _per_row_timing(torch, fns: dict, reps: int, flops: float,
                    nbytes: float, slab_bytes: float, dtype: str) -> dict:
    """A per-row form's timing row: ``fns`` (kernel, wrapper, plain,
    library) in turns with CUDA events, then ``kernel`` (what the wrapper
    launches, its plan read back beforehand) from a CUDA graph. ``flops``
    counts the visible products; the bound reckons them as the shared-mask
    rows do, as 3xTF32 (2 products for int8 keys, exact in TF32), with the
    f32-FMA bound beside it."""
    ms, times = _time_turns(torch, fns, reps)
    products = 3 if dtype == "f32" else 2
    bound = _bound(products * flops, nbytes, PEAK_TF32_FLOPS)
    fma = _bound(flops, nbytes)
    graph_ms = _time_graph(torch, fns["kernel"], reps)
    return {"graph_ms": graph_ms, "kernel_ms": ms["kernel"],
            "wrapper_ms": ms["wrapper"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "runs_ms": times, **bound,
            "tf32_products": products, "bound_fma_ms": fma["bound_ms"],
            "bound_fma_by": fma["bound_by"],
            "share_of_bound": bound["bound_ms"] / graph_ms,
            "share_of_fma_bound": fma["bound_ms"] / graph_ms,
            "l2_warm": slab_bytes < 50e6}


def _dense_timing(torch, name, prefix, q, slab, mask, k, reps, slot_bytes,
                  sms, dtype) -> dict:
    """The dense form ``name`` timed under ``mask``: what its wrapper
    launches (pass 0, the ranking of its keys, pass 1, the merge) from a CUDA
    graph, the plan read back once here. Its bound counts the visible pairs'
    products and reads q, the mask and the slots of the tiles some row
    sees."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    b, d = q.shape
    n = mask.shape[1]
    keys, scales = slab[0], (slab[1] if len(slab) == 2 else None)
    neg = torch.tensor(float("-inf"), device="cuda")
    _tile_summary_check(torch, mask, f"timing {name} N={n}")
    _, _, groups, most = kmod.masked_plan(q, keys, mask, k, scales)

    def kernel():
        bits, _, _, order = kmod.tile_summary(mask)
        return kmod._launch(name, q, keys, (mask, order, bits), k, scales,
                            intervals=(groups, most * kmod.BLOCK_N))

    fns = {"kernel": kernel,
           "wrapper": lambda: getattr(kmod, f"{name}_cuda")(q, *slab, mask,
                                                            k),
           "plain": lambda: getattr(ref, f"{prefix}cosine_topk_ref")(
               q, *slab, mask, k),
           "library": lambda: torch.topk(torch.where(
               mask, q @ _as_f32(torch, *slab).T, neg), k)}
    seen = int(ref.visible_tiles_ref(mask).any(0).sum())
    union = min(seen * kmod.BLOCK_N, n)
    nbytes = b * d * 4 + union * slot_bytes + b * n + b * k * 8
    row = _per_row_timing(torch, fns, reps, 2.0 * d * int(mask.sum()),
                          nbytes, n * slot_bytes, dtype)
    row["split"] = dict(zip(SPLIT_KEYS, kmod.split(
        b, n, sms, groups, most * kmod.BLOCK_N, dense=True)))
    row["distinct_keys"], row["most_tiles"] = groups, most
    return row


def _same_for_sorted_rows(torch, wrapper, perm, call, name) -> None:
    """A per-row kernel on the rows as given (``wrapper()``) and on the same
    rows permuted by ``perm`` (``call(perm)``): each row's top-k equal bit
    for bit, or fail."""
    s1, i1 = wrapper()
    s2, i2 = call(perm)
    back = torch.argsort(perm)
    if not (torch.equal(s1.view(torch.int32), s2[back].view(torch.int32))
            and torch.equal(i1, i2[back])):
        fail(f"{name}: the top-k of a row depends on where the row lies")


def _device_kernels(torch, fn) -> dict:
    """The card's kernel launches of one call of ``fn``, by name, from
    ``torch.profiler`` (empty if the profiler saw none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _probe_timing(torch, card: str) -> dict:
    """The IVF probe: the cosine kernel over the 128 centroids at k=16, its
    split, and the kernels one call launches on the card (one: pass 1 of
    4-row tiles, no merge)."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.kernels import ref
    b, d, n, k = 128, 384, 128, 16
    gen = torch.Generator(device="cuda").manual_seed(13)
    cents = _make_keys(torch, gen, n, d, "f32")
    q = torch.randn((b, d), generator=gen, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    always = torch.ones(n, dtype=torch.bool, device="cuda")

    def probe():
        return kmod.cosine_topk_cuda(q, cents, always, k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_chunk, chunks, block_q = kmod.split(b, n, sms)
    split = {"keys_per_chunk": per_chunk, "chunks": chunks,
             "block_q": block_q, "blocks": chunks * -(-b // block_q)}
    on_card = _device_kernels(torch, probe)
    if on_card and sum(on_card.values()) != 1:
        fail(f"the IVF probe launched {on_card} on the card, not one kernel")
    ms, times = _time_turns(torch, {
        "kernel": probe,
        "plain": lambda: ref.cosine_topk_ref(q, cents, always, k),
        "library": lambda: torch.topk(q @ cents.T, k)}, 200)
    bound = _bound(2.0 * b * n * d, b * d * 4 + n * d * 4 + n + b * k * 8)
    graph_ms = _time_graph(torch, probe, 200)
    row = {"kernel_ms": ms["kernel"], "graph_ms": graph_ms,
           "plain_ms": ms["plain"], "library_ms": ms["library"],
           "runs_ms": times, **bound,
           "share_of_bound": bound["bound_ms"] / graph_ms, "split": split,
           "device_kernels_per_call": on_card or
           "not measured: the profiler saw no kernel"}
    emit("timing", kernel="cosine_topk", role="IVF probe", B=b, N=n, d=d,
         k=k, key_dtype="f32", card=card, **row)
    return {("cosine_topk_probe", n, "f32"): row}


def _ivf_timing(torch, card: str) -> dict:
    """The IVF kernel at the serve shape (the real candidate matrix of the
    first served batch) with the probe's grouping (``serve``, as
    ``IVFIndex.search`` calls it) and without (``serve_ungrouped``), and
    with every one of the 16,384 ids visible and random (``all_visible``,
    no grouping), each in turns with its plain version and a library call,
    beside the bound of what each call needs (grouped: cand at the probed
    buckets' live members, the table rows and the probe; else the whole id
    matrix, which the grouped row also keeps as ``id_matrix_bound_ms``);
    then the whole ``IVFIndex.search`` (probe, candidates with their dedup
    sort, the kernel) from one CUDA graph, for the kernel's share."""
    from repro_torch.core import store
    from repro_torch.kernels import ref
    from repro_torch.kernels.ivf_topk import ivf_topk_cuda
    eng, q, slab, cand, probe, buckets = _ivf_serve_candidates(torch)
    slab = slab.float()
    gen = torch.Generator(device="cuda").manual_seed(17)
    every = torch.randint(0, slab.shape[0], cand.shape, generator=gen,
                          device="cuda", dtype=torch.int32)
    b, d = q.shape
    k = 4
    neg = torch.tensor(float("-inf"), device="cuda")
    out = {}
    for shape, ids, kw in (
            ("serve", cand, dict(probe=probe, buckets=buckets)),
            ("serve_ungrouped", cand, {}), ("all_visible", every, {})):
        for dtype in ("f32", "int8"):
            keys = slab if dtype == "f32" else torch.clamp(
                torch.round(slab * 127.0), -127, 127).to(torch.int8)

            def kernel():
                return ivf_topk_cuda(q, keys, ids, k, **kw)

            def plain():
                return ref.ivf_topk_ref(q, keys, ids, k)

            def library():
                return torch.topk(torch.where(
                    ids >= 0, torch.einsum(
                        "bd,bmd->bm", q,
                        _as_f32(torch, keys)[ids.clamp(min=0).long()]),
                    neg), k)
            reps = 10 if shape == "all_visible" else 100
            ms, times = _time_turns(torch, {"kernel": kernel, "plain": plain,
                                            "library": library}, reps)
            # the work this candidate matrix needs: each visible pair
            # scored once, each distinct visible slab row read once, and
            # the ids: the whole id matrix, or with the grouping cand only
            # where the probed bucket has a live member, the probed
            # buckets' rows of the table and the probe
            vis = ids >= 0
            pairs = int(vis.sum())
            rows = int(torch.unique(ids[vis]).numel())
            flops = 2.0 * d * pairs
            rest = b * d * 4 + rows * d * keys.element_size() + b * k * 8
            matrix = _bound(flops, ids.numel() * 4 + rest)
            bound = matrix
            if kw:
                live = ((buckets >= 0) & (buckets < slab.shape[0])).sum(1)
                bound = _bound(flops, 4 * (
                    int(live[probe.long()].sum())
                    + int(torch.unique(probe).numel()) * buckets.shape[1]
                    + probe.numel()) + rest)
            graph_ms = _time_graph(torch, kernel, reps)
            row = {"kernel_ms": ms["kernel"], "graph_ms": graph_ms,
                   "plain_ms": ms["plain"], "library_ms": ms["library"],
                   "runs_ms": times, **bound,
                   "share_of_bound": bound["bound_ms"] / graph_ms,
                   "id_matrix_bound_ms": matrix["bound_ms"],
                   "share_of_id_matrix_bound": matrix["bound_ms"] / graph_ms,
                   "visible_pairs": pairs, "distinct_rows": rows}
            out[("ivf_topk", shape, dtype)] = row
            emit("timing", kernel="ivf_topk", shape=shape, B=b,
                 M=ids.shape[1], N=slab.shape[0], d=d, k=k, key_dtype=dtype,
                 grouped=bool(kw), card=card, **row)
    # the whole lookup of the IVF serve path, from one graph
    index, st = eng.cache.index, eng.runtime.index_state
    alive = store.alive_mask(eng.state, eng._now)
    keys = eng.state.keys

    def search():
        return index.search(st, q, keys, alive)
    search_ms = _time_graph(torch, search, 100)
    kernel_ms = out[("ivf_topk", "serve", "f32")]["graph_ms"]
    emit("timing", kernel="ivf_topk", role="IVFIndex.search (probe, "
         "candidates, kernel)", B=b, key_dtype="f32", card=card,
         search_graph_ms=search_ms, kernel_graph_ms=kernel_ms,
         kernel_share=kernel_ms / search_ms)
    return out


# --------------------------------------------------------------------- #
# the model-backed miss path (``launch.serve --backend model``)
# --------------------------------------------------------------------- #
# kernel and plain version both take f32 products and sums, in other
# orders: f32 outputs agree to 2e-5; a bf16 output may round the other way
# once, one bf16 ulp (at most 2**-7 of the value)
ATTN_TOL = {"f32": (2e-5, 2e-5), "bf16": (2.0 ** -7, 1e-5)}   # (rtol, atol)
# the decode kernel's log-sum-exp against the plain version's, absolute:
# both sum f32 exponentials of f32 scores in other orders (f32 and int8
# caches: 1e-5 at the |lse| of 1-10 these inputs give); a bf16 cache's
# scores come from the tensor cores' f32 sums of exact bf16 products, whose
# adder rounds otherwise than IEEE f32: 1e-4
DECODE_LSE_TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 1e-4}
# a cache cut into slot ranges, each range's kernel output merged by its
# log-sum-exp (models.attention.merge_lse), against the whole call: f32
# parts as ATTN_TOL; bf16 parts are each rounded to bf16 before the merge
# (half an ulp, 2**-9 of |part| <= 1 here) and the merge rounds once more
MERGE_TOL = {"f32": (2e-5, 2e-5), "int8": (2e-5, 2e-5),
             "bf16": (2.0 ** -7, 2.0 ** -8)}
# full-width yi-6b, kernels against the plain attention on the same bf16
# weights and tokens: only the attention outputs' bf16 rounding differs
# (one ulp in some elements), and 32 layers of bf16 GEMMs carry the flips
# on (measured on an H100 with these weights: the prefill logits differ by
# 1.6% on average, 1.7% at most); a broken kernel moves the logits by their
# whole range
MODEL_LOGIT_REL = 0.1       # max |diff| / max |plain logit|
MODEL_LOGIT_MEAN_REL = 0.05  # mean |diff| / mean |plain logit|
TIE_TOL = 1e-4              # f32 top-two gap under which a token may flip
PROMPT, NEW_TOKENS = 64, 24  # ModelBackend's defaults
DECODE_PER_STEP_LAYERS = NEW_TOKENS - 1


def _attn_inputs(torch, gen, shapes, dtype):
    """Normal tensors on the card: the first scaled by 0.3 (q, k), the
    rest unscaled (v)."""
    out = []
    for i, shape in enumerate(shapes):
        x = torch.randn(shape, generator=gen, device="cuda")
        out.append((x * 0.3 if i < 2 else x).to(dtype))
    return out


def _attn_err(torch, out, want, dtype, where) -> float:
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[dtype]
    a, b = out.float(), want.float()
    if out.dtype != want.dtype or out.shape != want.shape:
        fail(f"{where}: output {out.dtype} {tuple(out.shape)}, plain "
             f"{want.dtype} {tuple(want.shape)}")
    if not bool(torch.all((a - b).abs() <= atol + rtol * b.abs())):
        fail(f"{where}: kernel and plain version differ by up to "
             f"{float((a - b).abs().max())} (rtol {rtol}, atol {atol})")
    return float((a - b).abs().max())


def _flash_cases(torch) -> float:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    cases = [  # (B, Lq, Lk, H, HKV, D, window, n_sink)
        (40, 64, 64, 32, 4, 128, None, 0),    # the serve path, G=8
        (4, 64, 64, 4, 2, 64, None, 0),       # the reduced yi-6b, G=2
        (2, 100, 100, 8, 8, 64, None, 0),     # ragged, G=1
        (2, 256, 256, 8, 2, 128, 100, 0),     # window, G=4
        (1, 256, 256, 16, 2, 64, 64, 0),      # window, G=8
        (2, 64, 256, 8, 2, 128, None, 0),     # Lk > Lq
        (2, 100, 256, 8, 1, 64, 80, 0),       # Lk > Lq, ragged, window
        (39, 64, 64, 32, 4, 128, None, 0),    # the serve shape at B=39
        (3, 200, 200, 16, 2, 128, None, 0),   # four KV tiles, a ragged tail
        # attention sinks (hymba's meta tokens), windows that drop keys
        (2, 256, 256, 8, 2, 64, 64, 20),      # n_sink < one 64-key tile
        (1, 400, 400, 10, 2, 64, 70, 150),    # sinks span tiles, G=5
        (1, 300, 300, 12, 2, 128, 50, 128),   # two whole sink tiles, G=6
        (2, 130, 130, 5, 1, 64, 32, 200),     # n_sink >= Lk
        (2, 100, 300, 6, 1, 128, 90, 70),     # Lk > Lq with sinks, G=6
        (40, 64, 64, 48, 8, 128, None, 0),    # grok-1's serve shape, G=6
        (40, 64, 64, 40, 8, 128, None, 0),    # llama4's serve shape, G=5
        (40, 192, 192, 25, 5, 64, 1024, 128),  # hymba's serve shape, G=5
        (2, 2048, 2048, 25, 5, 64, 1024, 128),  # hymba, the window drops
    ]
    worst = 0.0
    torch_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}
    for dtype in ("f32", "bf16"):
        gen = torch.Generator(device="cuda").manual_seed(41)
        errs = []
        for b, lq, lk, h, hkv, d, window, sink in cases:
            q, k, v = _attn_inputs(torch, gen, ((b, lq, h, d), (b, lk, hkv, d),
                                                (b, lk, hkv, d)),
                                   torch_dtype[dtype])
            kw = dict(window=window, n_sink=sink)
            errs.append(_attn_err(
                torch, flash_attention_cuda(q, k, v, **kw),
                ref.flash_attention_ref(q, k, v, **kw), dtype,
                f"flash {dtype} B={b} Lq={lq} Lk={lk} H={h} HKV={hkv} "
                f"D={d} window={window} n_sink={sink}"))
        emit("model", kernel="flash_attention", dtype=dtype, cases=len(cases),
             max_abs_err=max(errs), rtol_atol=ATTN_TOL[dtype])
        worst = max(worst, max(errs))
    return worst


def _decode_slots(torch, s, layout):
    """(slot_pos (S,) int32 on the card, pos). ``prefix``: the serve path
    at its 12th decode step (76 of 96 slots written); ``ring``: a wrapped
    ring, a quarter newest, a quarter older, half empty; ``meta``: hymba's
    serve ring at its first decode step (positions S..2S-1 after a 2S-token
    prefill, slot 0 then overwritten by position 2S): with 128 sinks and S
    = 96, meta tokens 97-127 are still in it; ``full``: every slot;
    ``none``: every stored position past pos."""
    sp = torch.full((s,), -1, dtype=torch.int32)
    if layout == "meta":
        pos = 2 * s
        sp = torch.arange(s, dtype=torch.int32) + s
        sp[0] = pos
    elif layout == "prefix":
        pos = PROMPT + 11
        sp[:pos + 1] = torch.arange(pos + 1, dtype=torch.int32)
    elif layout == "ring":
        pos = s + s // 4 - 1
        sp[:s // 4] = torch.arange(s // 4, dtype=torch.int32) + s
        sp[s // 4:s // 2] = torch.arange(s // 4, s // 2, dtype=torch.int32)
    else:
        pos = s - 1
        sp = torch.arange(s, dtype=torch.int32)
        if layout == "none":
            sp += s
    return sp.to("cuda"), pos


def _decode_operands(torch, gen, b, s, h, hkv, d, kv):
    from repro_torch.models.attention import quantize_kv
    dtype = torch.bfloat16 if kv == "bf16" else torch.float32
    q, k, v = _attn_inputs(torch, gen, ((b, 1, h, d), (b, s, hkv, d),
                                        (b, s, hkv, d)), dtype)
    if kv != "int8":
        return q, k, v, None, None
    k, ks = quantize_kv(k)
    v, vs = quantize_kv(v)
    return q, k, v, ks, vs


def _decode_cases(torch) -> tuple[float, float]:
    """Every case through the kernel, without and with its lse, against
    the plain version: (worst output error, worst lse error)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    cases = [  # (B, S, H, HKV, D, window, n_sink, slot layout)
        (40, 96, 32, 4, 128, None, 0, "prefix"),   # the serve path
        (4, 96, 4, 2, 64, None, 0, "prefix"),      # the reduced yi-6b
        (3, 512, 8, 2, 64, None, 0, "ring"),
        (3, 96, 6, 2, 64, 32, 8, "full"),          # window with sinks
        (2, 512, 32, 4, 128, 100, 4, "ring"),
        (2, 512, 16, 1, 256, None, 0, "full"),     # G=16, D=256
        (3, 96, 32, 4, 128, None, 0, "none"),      # nothing visible: 0
        (1, 96, 32, 4, 128, None, 0, "prefix"),    # B=1
        (2, 1, 8, 2, 64, None, 0, "full"),         # S=1
        (3, 17, 8, 2, 64, None, 0, "full"),        # S=17, one split
        (8, 4096, 32, 4, 128, None, 0, "full"),    # yi-6b's context, splits
        (3, 512, 32, 4, 128, None, 0, "ring"),     # whole splits empty
        (2, 1024, 16, 1, 256, 300, 2, "ring"),     # G=16, D=256, split
        (2, 4096, 8, 2, 64, None, 0, "none"),      # splits, nothing visible
        (1, 20000, 4, 1, 64, None, 0, "ring"),     # 128 splits of two tiles
        (40, 96, 48, 8, 128, None, 0, "prefix"),   # grok-1's serve shape, G=6
        (40, 96, 40, 8, 128, None, 0, "prefix"),   # llama4's, G=5
        (40, 96, 25, 5, 64, 1024, 128, "meta"),    # hymba's ring with sinks
        (3, 96, 25, 5, 64, 32, 128, "meta"),       # its sinks past a window
        (2, 512, 10, 2, 64, 60, 70, "full"),       # G=5, window and sinks
    ]
    worst = lse_worst = 0.0
    for kv in ("f32", "bf16", "int8"):
        gen = torch.Generator(device="cuda").manual_seed(43)
        errs, lse_errs = [], []
        for b, s, h, hkv, d, window, sink, layout in cases:
            q, k, v, ks, vs = _decode_operands(torch, gen, b, s, h, hkv, d,
                                               kv)
            sp, pos = _decode_slots(torch, s, layout)
            kw = dict(window=window, n_sink=sink, k_scale=ks, v_scale=vs)
            out = decode_attention_cuda(q, k, v, sp, pos, **kw)
            where = (f"decode {kv} B={b} S={s} H={h} HKV={hkv} D={d} "
                     f"window={window} sink={sink} {layout}")
            errs.append(_attn_err(
                torch, out, ref.decode_attention_ref(q, k, v, sp, pos, **kw),
                "bf16" if kv == "bf16" else "f32", where))
            if layout == "none" and not bool(torch.all(out == 0)):
                fail(f"{where}: a row with nothing visible is not 0")
            lse_errs.append(_lse_check(torch, out, decode_attention_cuda(
                q, k, v, sp, pos, return_lse=True, **kw),
                ref.decode_attention_ref(q, k, v, sp, pos, return_lse=True,
                                         **kw)[1], kv, where))
        emit("model", kernel="decode_attention", kv_dtype=kv,
             cases=len(cases), max_abs_err=max(errs),
             rtol_atol=ATTN_TOL["bf16" if kv == "bf16" else "f32"],
             lse_max_abs_err=max(lse_errs), lse_atol=DECODE_LSE_TOL[kv],
             out_with_lse="bit for bit")
        worst = max(worst, max(errs))
        lse_worst = max(lse_worst, max(lse_errs))
    return worst, lse_worst


def _lse_check(torch, out, got, want_lse, kv, where) -> float:
    """The kernel's output with its log-sum-exp (``got``) against the
    output without (bit for bit) and the plain version's lse (``-inf`` in
    the same places, else within DECODE_LSE_TOL)."""
    o, lse = got
    torch.cuda.synchronize()
    if not torch.equal(o, out):
        fail(f"{where}: the output with lse differs from the output without")
    if lse.dtype != torch.float32 or lse.shape != want_lse.shape:
        fail(f"{where}: lse {lse.dtype} {tuple(lse.shape)}, plain "
             f"{want_lse.dtype} {tuple(want_lse.shape)}")
    inf, want_inf = torch.isinf(lse), torch.isinf(want_lse)
    if not torch.equal(inf, want_inf) or bool(torch.isnan(lse).any()) or \
            not bool((lse[inf] < 0).all()):
        fail(f"{where}: the lse's -inf rows differ from the plain version's")
    err = float((lse[~inf] - want_lse[~inf]).abs().max()) \
        if bool((~inf).any()) else 0.0
    if err > DECODE_LSE_TOL[kv]:
        fail(f"{where}: lse differs from the plain version's by {err} "
             f"(atol {DECODE_LSE_TOL[kv]})")
    return err


def _decode_split_merge(torch) -> dict:
    """A cache cut into 2 and 4 slot ranges (as context-parallel decode
    splits it over the ranks of ``model``), each range through the kernel
    with its lse, merged by ``merge_lse``, against the whole call: at the
    serve step (B = 39, S = 96) and at yi-6b's context (B = 8, S = 4,096),
    f32, bf16 and int8 caches."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import merge_lse

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)
    worst = {}
    for kv in ("f32", "bf16", "int8"):
        gen = torch.Generator(device="cuda").manual_seed(53)
        errs = []
        for b, s, layout in ((39, 96, "prefix"), (8, 4096, "full")):
            q, k, v, ks, vs = _decode_operands(torch, gen, b, s, 32, 4, 128,
                                               kv)
            sp, pos = _decode_slots(torch, s, layout)
            whole = ops.decode_attention(q, k, v, sp, pos, k_scale=ks,
                                         v_scale=vs)
            for n in (2, 4):
                cuts = [i * s // n for i in range(n + 1)]
                parts = []
                for lo, hi in zip(cuts, cuts[1:]):
                    def cut(x):
                        return None if x is None else \
                            x[:, lo:hi].contiguous()
                    parts.append(ops.decode_attention(
                        q, cut(k), cut(v), sp[lo:hi].contiguous(), pos,
                        k_scale=cut(ks), v_scale=cut(vs), return_lse=True))
                got = merge_lse(torch.stack([o for o, _ in parts]),
                                torch.stack([x for _, x in parts]), stacked)
                torch.cuda.synchronize()
                rtol, atol = MERGE_TOL[kv]
                a, w = got.float(), whole.float()
                err = float((a - w).abs().max())
                if got.dtype != whole.dtype or \
                        not bool(torch.all((a - w).abs()
                                           <= atol + rtol * w.abs())):
                    fail(f"decode split {kv} B={b} S={s} into {n}: merged "
                         f"ranges differ from the whole call by {err} "
                         f"(rtol {rtol}, atol {atol})")
                errs.append(err)
        worst[kv] = max(errs)
        emit("model", kernel="decode_attention", check="slot ranges merged "
             "by lse equal the whole call", kv_dtype=kv, ranges=[2, 4],
             shapes=["B=39 S=96", "B=8 S=4096"], max_abs_err=worst[kv],
             rtol_atol=MERGE_TOL[kv])
    return worst


class _Recorder:
    """Wraps a ``ModelBackend``'s model: times ``forward`` (prefill) and
    ``decode_step`` (decode) per ``generate`` call with a card sync at both
    ends, keeps a device-side all-finite flag of every logit tensor, and the
    queries of each call. The sync points wait for work the next step
    would wait for anyway."""

    def __init__(self, torch, backend):
        self.torch, self.backend = torch, backend
        self.model = backend.model
        self.calls = []
        self.finite = []
        self._fwd, self._dec = self.model.forward, self.model.decode_step
        self._gen = backend.generate
        self.model.forward = self._timed("prefill_s", self._fwd)
        self.model.decode_step = self._timed("decode_s", self._dec)
        backend.generate = self._generate

    def _timed(self, key, fn):
        torch = self.torch

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            logits = out[0] if isinstance(out, tuple) else out
            self.finite.append(torch.isfinite(logits).all())
            torch.cuda.synchronize()
            self.calls[-1][key] += time.perf_counter() - t0
            return out
        return run

    def _generate(self, queries, semantic_keys=None):
        self.calls.append({"misses": len(queries), "prefill_s": 0.0,
                           "decode_s": 0.0, "queries": list(queries)})
        t0 = time.perf_counter()
        res = self._gen(queries, semantic_keys)
        self.calls[-1]["generate_s"] = time.perf_counter() - t0
        return res

    def all_finite(self) -> bool:
        return bool(self.torch.stack(self.finite).all())

    def restore(self):
        # the wrapped methods were the classes' own: drop the instance ones
        del self.model.forward, self.model.decode_step
        del self.backend.generate


def _greedy(torch, model, tokens, forced=None):
    """``ModelBackend.generate``'s prefill and decode on token ids: returns
    the logits of the second forward, of the first decode step, and the
    (B, 24) greedy tokens. With ``forced`` (B, 24) tokens, each step is fed
    ``forced``'s token instead of its own (teacher forcing), so two runs'
    logits stay comparable after a near-tie flips one token."""
    with torch.inference_mode():
        _, caches = model(tokens, collect_cache=True,
                          cache_size=PROMPT + NEW_TOKENS + 8)
        logits = model(tokens)
        out = [torch.argmax(logits[:, -1:], dim=-1)]
        first = None
        for i in range(NEW_TOKENS - 1):
            feed = out[-1] if forced is None else forced[:, i:i + 1]
            dl, caches = model.decode_step(caches, feed)
            first = dl if first is None else first
            out.append(torch.argmax(dl, dim=-1))
    return logits, first, torch.cat(out, dim=1)


def _plain_attention():
    """Point ``ops``' attention at the plain versions (the card's path
    otherwise has no way to them); returns the undo."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = ref.flash_attention_ref
    ops.decode_attention = ref.decode_attention_ref

    def undo():
        ops.flash_attention, ops.decode_attention = saved
    return undo


def _logit_gap(a, b, vocab: int | None = None) -> dict:
    """max |a - b| and its share of max |b|, mean |a - b| over mean |b|,
    over the first ``vocab`` columns (the padding columns hold -1e9)."""
    a, b = a[..., :vocab].float(), b[..., :vocab].float()
    d = (a - b).abs()
    ref = b.abs()
    return {"max_abs": float(d.max()), "max_rel": float(d.max() / ref.max()),
            "mean_rel": float(d.mean() / ref.mean())}


def _profile_generate(torch, backend, call: dict) -> dict:
    """One ``generate`` of ``call``'s queries under ``torch.profiler``: the
    card's kernel time in total, for the names that take the most and for
    the attention kernels, beside the same call's unprofiled wall time from
    the serve run (the profiler's own host work slows the profiled call).
    The idle share is 1 - kernel time / unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backend.generate(call["queries"])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return {"device_time": "not measured: the profiler saw no kernel"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    attention = [e for e in kernels
                 if "decode_" in e.key or "flash_attention" in e.key]
    return {"rows": call["misses"], "kernel_s": busy_us / 1e6,
            "attention_kernels": [{"name": e.key[:80], "count": e.count,
                                   "s": e.self_device_time_total / 1e6}
                                  for e in attention],
            "wall_unprofiled_s": call["generate_s"],
            "idle_share": 1.0 - busy_us / 1e6 / call["generate_s"],
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "s": e.self_device_time_total / 1e6}
                            for e in top]}


class _GapRecorder:
    """Records, per ``generate`` call of a backend, each row's smallest
    top-two logit gap over its greedy steps (the logits of the second
    forward's last position and of every decode step)."""

    def __init__(self, torch, backend):
        self.torch, self.backend, self.model = torch, backend, backend.model
        self.calls = []
        self._fwd, self._dec = self.model.forward, self.model.decode_step
        self._gen = backend.generate
        self.model.forward = self._wrap(self._fwd)
        self.model.decode_step = self._wrap(self._dec)
        backend.generate = self._generate

    def _wrap(self, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if isinstance(out, tuple) and not kw.get("collect_cache"):
                logits = out[0]       # decode_step
            elif isinstance(out, tuple):
                return out            # the prefill that builds the caches
            else:
                logits = out
            top2 = self.torch.topk(logits[:, -1].float(), 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).cpu()
            rows = self.calls[-1]["gap"]
            self.calls[-1]["gap"] = gap if rows is None else \
                self.torch.minimum(rows, gap)
            return out
        return run

    def _generate(self, queries, semantic_keys=None):
        self.calls.append({"queries": list(queries), "gap": None})
        return self._gen(queries, semantic_keys)

    def near_ties(self) -> set:
        return {q for c in self.calls for q, g in zip(c["queries"], c["gap"])
                if float(g) < TIE_TOL}


def _reduced_card_vs_cpu(torch, arch: str = "yi-6b") -> dict:
    """``--backend model --arch <arch>`` (reduced, f32) on the card and on
    the CPU with the same weights: every request's decision and answer."""
    from repro_torch.launch import serve
    kw = dict(corpus=50, queries=25, backend="model", arch=arch,
              log=lambda *a: None)
    card, reqs = serve.build(device="cuda", **kw)
    cpu, cpu_reqs = serve.build(device="cpu", **kw)
    cpu.backend.model.load_state_dict(
        {n: t.cpu() for n, t in card.backend.model.state_dict().items()})
    gaps = _GapRecorder(torch, cpu.backend)
    _reset_launches()
    resp = card.process(reqs)
    torch.cuda.synchronize()
    launches = _launches()
    cpu_resp = cpu.process(cpu_reqs)
    size = card.batcher.batch_size
    batches = range(0, len(reqs), size)
    with_misses = sum(any(not r.cached for r in resp[i:i + size])
                      for i in batches)
    layers = _attention_layers(card.backend.model.config)
    _expect_launches(launches, {
        "cosine_topk": len(batches),
        "flash_attention": 2 * layers * with_misses,
        "decode_attention": DECODE_PER_STEP_LAYERS * layers * with_misses},
        f"reduced {arch} serving")
    ties = gaps.near_ties()
    differing = 0
    for i, (a, b) in enumerate(zip(resp, cpu_resp)):
        if a.cached != b.cached or abs(a.score - b.score) > 1e-5:
            fail(f"reduced {arch}: request {i} decision differs card vs cpu")
        if a.answer != b.answer:
            if reqs[i].query not in ties:
                fail(f"reduced {arch}: request {i} answer differs card vs "
                     f"cpu with no near-tie: {a.answer!r} vs {b.answer!r}")
            differing += 1
    out = {"requests": len(resp), "misses": sum(not r.cached for r in resp),
           "kernel_launches": launches, "near_tie_queries": len(ties),
           "answers_differing_at_near_ties": differing}
    emit("model", check=f"reduced {arch} f32, card vs cpu", **out)
    return out


def _attention_layers(cfg) -> int:
    """Layers that launch the attention kernels (none in the ssm family)."""
    return cfg.n_layers if cfg.has_attention else 0


def _attn_turns(torch, fns: dict, reps: int) -> dict:
    """Kernel, plain version and SDPA timed in turns with CUDA events, then
    the kernel and SDPA each from a CUDA graph of ``reps`` calls, in turns
    (kernel, SDPA, SDPA, kernel; best of two): ``graph_ms`` and
    ``library_ms`` are the graph times, ``library_host_ms`` the host-timed
    SDPA."""
    ms, times = _time_turns(torch, fns, reps)
    graph = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        graph[name].append(_time_graph(torch, fns[name], reps))
    return {"kernel_ms": ms["kernel"], "graph_ms": min(graph["kernel"]),
            "plain_ms": ms["plain"], "library_ms": min(graph["library"]),
            "library_host_ms": ms["library"], "runs_ms": times,
            "graph_runs_ms": graph}


def _decode_bound(q, k, vis: int) -> dict:
    """Bytes and operations one decode launch needs: q read and the output
    written once (q's dtype), the visible slots' K and V rows once (the
    cache's dtype, int8 with its two 4-byte scales a row), slot_pos; 4 D
    FLOP per query head and visible slot, at the bf16 tensor-core rate for
    a bf16 q and cache, else the f32 rate (the kernel's f32 FMAs)."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    # a visible (b, slot, kv-head): its K and V rows, and two f32 scales
    # when the cache is int8
    row = 2 * d * k.element_size() + (8 if k.element_size() == 1 else 0)
    tc = q.element_size() == 2 and k.element_size() == 2
    return _bound(4.0 * d * h * b * vis,
                  2 * q.numel() * q.element_size() + b * vis * hkv * row
                  + k.shape[1] * 4, PEAK_BF16_FLOPS if tc else PEAK_F32_FLOPS)


def _model_timing(torch, card: str, b: int, b_fewest: int) -> dict:
    """Both attention kernels against the plain versions and one SDPA call
    each, every kernel and SDPA also from CUDA graphs: flash at the serve
    path's prefill (B = mean misses a batch); decode at the serve path's
    step (B = the mean and the fewest misses a batch, S = 96, 76 visible)
    and at yi-6b's published 4,096-token context (B = 8, all visible,
    67 MB of K and V: past the 50 MB L2)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    h, hkv, d = 32, 4, 128
    gen = torch.Generator(device="cuda").manual_seed(47)
    out = {}
    q, k, v = _attn_inputs(torch, gen, ((b, PROMPT, h, d),
                                        (b, PROMPT, hkv, d),
                                        (b, PROMPT, hkv, d)), torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = _attn_turns(torch, {
        "kernel": lambda: flash_attention_cuda(q, k, v),
        "plain": lambda: ref.flash_attention_ref(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}, 100)
    pairs = PROMPT * (PROMPT + 1) // 2
    bound = _bound(4.0 * d * h * b * pairs,
                   2 * q.numel() * 2 + 2 * k.numel() * 2, PEAK_BF16_FLOPS)
    out["flash_attention"] = {**row, **bound,
                              "share_of_bound": bound["bound_ms"]
                              / row["graph_ms"]}
    emit("timing", kernel="flash_attention", B=b, L=PROMPT, H=h, HKV=hkv,
         D=d, dtype="bf16", causal=True, card=card,
         **out["flash_attention"])

    s_serve = PROMPT + NEW_TOKENS + 8
    for shape, bb, s, layout in (("serve", b, s_serve, "prefix"),
                                 ("fewest_misses", b_fewest, s_serve,
                                  "prefix"),
                                 ("yi6b_context", 8, 4096, "full")):
        q, k, v = _attn_inputs(torch, gen, ((bb, 1, h, d), (bb, s, hkv, d),
                                            (bb, s, hkv, d)), torch.bfloat16)
        sp, pos = _decode_slots(torch, s, layout)
        visible = (sp >= 0) & (sp <= pos)
        vis = int(visible.sum())
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = visible[None, None, None, :]
        row = _attn_turns(torch, {
            "kernel": lambda: decode_attention_cuda(q, k, v, sp, pos),
            "plain": lambda: ref.decode_attention_ref(q, k, v, sp, pos),
            "library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)},
            200 if s <= 128 else 50)
        bound = _decode_bound(q, k, vis)
        n_split, tile = kdec.split(s, d, k.element_size())
        # with and without the log-sum-exp, from graphs, in turns
        lse = {"kernel": [], "kernel_lse": []}
        for name in ("kernel", "kernel_lse", "kernel_lse", "kernel"):
            lse[name].append(_time_graph(torch, lambda: decode_attention_cuda(
                q, k, v, sp, pos, return_lse=name == "kernel_lse"),
                200 if s <= 128 else 50))
        out[("decode_attention", shape)] = {
            **row, **bound, "visible_slots": vis, "n_split": n_split,
            "tile": tile, "share_of_bound": bound["bound_ms"]
            / row["graph_ms"], "graph_ms_no_lse": min(lse["kernel"]),
            "graph_ms_lse": min(lse["kernel_lse"]), "lse_runs_ms": lse}
        emit("timing", kernel="decode_attention", shape=shape, B=bb, S=s,
             H=h, HKV=hkv, D=d, pos=pos, dtype="bf16", card=card,
             **out[("decode_attention", shape)])
    out["decode_attention"] = out[("decode_attention", "serve")]
    return out


def phase_model(torch, card: str, sim_cached: list) -> dict:
    """The model-backed miss path: both attention kernels against their
    plain versions, full-width yi-6b serving (all 16 batches, decisions
    ``sim_cached``: the main phase's), the reduced model card vs CPU, and
    the kernels' times at the serve shape."""
    dec_err, lse_err = _decode_cases(torch)
    max_err = {"flash_attention": _flash_cases(torch),
               "decode_attention": dec_err}
    lse = {"max_abs_err": lse_err, "split_merge": _decode_split_merge(torch)}
    full = _model_serve(torch, "yi-6b", None, sim_cached, MAIN_BATCHES,
                        "model")
    _reduced_card_vs_cpu(torch)
    b = max(1, round(sum(full["misses_per_batch"])
                     / len(full["misses_per_batch"])))
    return {"max_err": max_err, "launches": full["kernel_launches"],
            "lse": lse, "timing": _model_timing(torch, card, b,
                                                min(full["misses_per_batch"]))}


# --------------------------------------------------------------------- #
# the moe, ssm and hybrid families behind the miss path
# --------------------------------------------------------------------- #
# (arch, layers kept or None for all): grok-1 (314B) and llama4 (400B) do
# not fit one 80 GB card, so they run at full width and reduced depth
FAMILIES = (("grok-1-314b", 2), ("llama4-maverick-400b-a17b", 2),
            ("mamba2-130m", None), ("hymba-1.5b", None))
FAMILY_BATCHES = 2          # of the main configuration's 16
VS_PLAIN = ("yi-6b", "grok-1-314b", "hymba-1.5b", "qwen2-vl-2b")
CONTINUATION_STEPS = 8      # mamba2: decode after prefill vs the forward
CONTINUATION_F32_REL = 1e-3  # f32: max |diff| / max |logit|


def _free_card(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# a bf16 attention output one ulp off moves a token's router probabilities
# a little (XLA against PyTorch on the CPU, two layers: up to 3.1e-3);
# where two of its top k + 1 experts are that close it may take the other,
# and its logits move wholesale (grok-1 at full width, kernels against
# plain attention: 0.32 of the largest logit on one row, 0.65% on average,
# on an NVIDIA H100 80GB HBM3 at 700 W)
ROUTE_TIE = 1e-2
# at capacity 1.25 one token routed apart shifts the ranks of its experts'
# later tokens, and a token at the capacity edge then keeps or loses a
# choice (grok-1, first miss batch: 488 of 2,560 prefill rows and 14 of 40
# sequences left out on an H100 at 700 W); at least half must be compared
MAX_REROUTED_SHARE = 0.5


class _RoutingRecorder:
    """Records, for every MoE call of the model, each token's experts in
    choice order, which of its choices kept a slot, and its router's
    smallest gap between consecutive probabilities of its top k + 1 (two
    choices swapping order also moves the ranks, hence the drops, of the
    tokens after it)."""

    def __init__(self, torch):
        from repro_torch.models import model as mm
        from repro_torch.models import moe
        self.torch, self.mm, self.moe = torch, mm, moe
        self.calls = []
        self._ffn = mm.moe_ffn
        mm.moe_ffn = self._record

    def _record(self, x, wr, wg, *w, topk, capacity_factor):
        torch, moe = self.torch, self.moe
        e = wg.shape[0]
        cap = max(int(math.ceil(x.shape[0] * topk / e * capacity_factor)), 1)
        _, ex, _ = moe.router(x, wr, topk)
        slots, _ = moe.dispatch_indices(ex, e, cap)
        top = torch.softmax(x.float() @ wr.float(), dim=-1).topk(
            topk + 1, dim=-1).values
        self.calls.append((ex, slots >= 0,
                           (top[:, :-1] - top[:, 1:]).amin(dim=-1)))
        return self._ffn(x, wr, wg, *w, topk=topk,
                         capacity_factor=capacity_factor)

    def restore(self):
        self.mm.moe_ffn = self._ffn


def _rerouted(torch, a: list, b: list, shape: tuple, prior, where: str):
    """Which (B, L) tokens two runs' MoE calls ``a`` and ``b`` (one per MoE
    layer, in order) routed apart (other experts, another order of them,
    or another choice dropped) or carried such a token's change: a
    rerouted token taints its own and its sequence's later positions in
    the layers after it (causal attention), and ``prior`` (B,) taints
    whole sequences (caches of an earlier pass). An untainted token
    taking other experts must sit at a near-tie (``ROUTE_TIE``); a drop
    that differs alone needs a token routed apart in its call (ranks are
    choice-major: any token's first choice ranks before every second
    choice, so a later token can move an earlier one's drop)."""
    tainted = prior[:, None].expand(shape).clone()
    for (ea, ka, gap), (eb, kb, _) in zip(a, b):
        other = (ea != eb).any(dim=-1).view(shape)
        dropped = (ka != kb).any(dim=-1).view(shape) & ~other
        fresh = other & ~tainted
        if bool((fresh & (gap.view(shape) >= ROUTE_TIE)).any()):
            fail(f"{where}: a token routed apart with a router gap of "
                 f"{float(gap.view(shape)[fresh].max())} >= {ROUTE_TIE}")
        if bool(dropped.any()) and not bool(other.any()):
            fail(f"{where}: a drop differs with no token routed apart")
        tainted |= (other | dropped).cumsum(dim=1) > 0
    return tainted


# hymba at full width in bf16, kernels against plain attention, same
# tokens fed: 32 layers amplify the attention outputs' one-ulp roundings
# (4.5% of the mean logit on average, 10.2% of the largest at most, on an
# H100 at 700 W; mamba2's decode against its own forward in bf16, no kernel
# involved: 2.7% / 9.0%), so its bf16 logits are held to twice yi-6b's
# bounds, and its f32 twin (the same weights in f32, the kernels' f32
# paths, rounding 2^-24 for 2^-8) to TWIN_F32_REL: a wrong mask moves the
# logits by their whole range
FAMILY_LOGIT_REL = {"hymba-1.5b": (0.2, 0.1)}   # (max, mean) share
TWIN_F32_REL = 1e-3


def _kernels_vs_plain_gaps(torch, model, tokens, arch) -> dict:
    """``_greedy`` through the kernels, then through the plain attention
    fed the kernel run's tokens, each with its MoE routing recorded; the
    logit gaps over the rows both runs routed alike."""
    runs = []
    for plain in (False, True):
        rec = _RoutingRecorder(torch)
        undo = _plain_attention() if plain else (lambda: None)
        try:
            runs.append((_greedy(torch, model, tokens, forced=runs[0][0][2]
                                 if plain else None), rec.calls))
        finally:
            undo()
            rec.restore()
    (k_logits, k_first, k_tokens), k_calls = runs[0]
    (p_logits, p_first, p_tokens), p_calls = runs[1]
    b, l = tokens.shape
    keep = torch.ones((b, l), dtype=torch.bool, device="cuda")
    live = torch.ones((b,), dtype=torch.bool, device="cuda")
    n = len(k_calls) // (2 + NEW_TOKENS - 1)      # MoE calls a pass
    if n:
        (c0, c1, c2) = [(k_calls[i * n:(i + 1) * n], p_calls[i * n:(i + 1) * n])
                        for i in range(3)]
        none = torch.zeros((b,), dtype=torch.bool, device="cuda")
        cache = _rerouted(torch, *c0, (b, l), none, f"{arch} first prefill")
        keep = ~_rerouted(torch, *c1, (b, l), none, f"{arch} second prefill")
        live = ~_rerouted(torch, *c2, (b, 1), cache.any(dim=1),
                          f"{arch} first decode step")[:, 0]
    v = model.config.vocab
    return {"prefill_logits": _logit_gap(k_logits[keep], p_logits[keep], v),
            "first_decode_logits": _logit_gap(k_first[live], p_first[live],
                                              v),
            "all_rows": {"prefill_logits": _logit_gap(k_logits, p_logits, v),
                         "first_decode_logits": _logit_gap(k_first, p_first,
                                                           v)},
            "prefill_rows_rerouted": int((~keep).sum()),
            "prefill_rows": keep.numel(),
            "sequences_rerouted": int((~live).sum()),
            "greedy_tokens_equal_share": float((k_tokens == p_tokens).float()
                                               .mean())}


def _kernels_vs_plain(torch, model, queries, tokenizer, arch,
                      phase: str) -> dict:
    """The first miss batch again, kernels against the plain attention,
    the plain run fed the kernel run's tokens (yi-6b, grok-1, hymba). MoE: rows whose tokens the two runs routed apart at a near-tie
    are reported and left out of the bounds: in the second prefill a
    token's row and its sequence's later rows (causal attention carries
    it forward), in the first decode step its sequence (the first
    prefill's caches and the step's own routing). hymba: bf16 bounds of
    ``FAMILY_LOGIT_REL``, and an f32 twin held to ``TWIN_F32_REL``."""
    import dataclasses
    from repro_torch.models.model import Model
    toks, _ = tokenizer.encode_batch(queries, PROMPT)
    tokens = torch.as_tensor(toks, dtype=torch.long, device="cuda")
    max_rel, mean_rel = FAMILY_LOGIT_REL.get(
        arch, (MODEL_LOGIT_REL, MODEL_LOGIT_MEAN_REL))
    out = {"rows": len(toks), **_kernels_vs_plain_gaps(torch, model, tokens,
                                                       arch),
           "tolerance": {"max_rel": max_rel, "mean_rel": mean_rel,
                         "route_tie": ROUTE_TIE,
                         "max_rerouted_share": MAX_REROUTED_SHARE}}
    if arch in FAMILY_LOGIT_REL:
        twin = Model(dataclasses.replace(model.config, dtype="float32"),
                     device="cuda")
        twin.load_state_dict(model.state_dict())       # cast to f32
        out["f32_twin"] = _kernels_vs_plain_gaps(torch, twin, tokens, arch)
        out["f32_twin"]["max_rel_bound"] = TWIN_F32_REL
        del twin
        _free_card(torch)
    emit(phase, check=f"full-width {arch} kernels vs plain attention, "
         "first miss batch", **out)
    if out["prefill_rows_rerouted"] > MAX_REROUTED_SHARE * out[
            "prefill_rows"] or out["sequences_rerouted"] > \
            MAX_REROUTED_SHARE * len(toks):
        fail(f"full-width {arch}: too many rows routed apart, kernels vs "
             f"plain attention: {out}")
    for name in ("prefill_logits", "first_decode_logits"):
        gap = out[name]
        if not (gap["max_rel"] <= max_rel and gap["mean_rel"] <= mean_rel):
            fail(f"full-width {arch} {name}: kernels vs plain attention "
                 f"{gap}")
        if "f32_twin" in out and \
                out["f32_twin"][name]["max_rel"] > TWIN_F32_REL:
            fail(f"full-width {arch} f32 twin {name}: kernels vs plain "
                 f"attention {out['f32_twin'][name]}")
    return out


def _continuation(torch, model, tokens) -> dict:
    """Greedy decode after a prefill against ``forward`` over the prompt
    and the tokens decoded so far, at the same positions (logical vocab
    only)."""
    v = model.config.vocab
    with torch.inference_mode():
        logits, caches = model(tokens, collect_cache=True)
        steps = [logits[:, -1:, :v].float()]
        out = [steps[0].argmax(-1)]
        for _ in range(CONTINUATION_STEPS):
            dl, caches = model.decode_step(caches, out[-1])
            steps.append(dl[..., :v].float())
            out.append(steps[-1].argmax(-1))
        decoded = torch.cat(out, dim=1)                 # (B, steps + 1)
        full = model(torch.cat([tokens, decoded[:, :-1]], dim=1))
    full = full[:, tokens.shape[1] - 1:, :v].float()    # the same positions
    diff = (torch.cat(steps, dim=1) - full).abs()
    top2 = torch.topk(full, 2, dim=-1).values
    # a token may differ only where the forward's top-two gap is under
    # twice that row's largest logit difference (a near-tie)
    ties = (top2[..., 0] - top2[..., 1]) < 2 * diff.amax(dim=-1)
    differ = full.argmax(-1) != decoded
    return {"tokens_equal_share": float((~differ).float().mean()),
            "near_ties": int(ties.sum()),
            "unexplained_differences": int((differ & ~ties).sum()),
            "max_abs_logit_diff": float(diff.max()),
            "max_rel": float(diff.max() / full.abs().max()),
            "mean_rel": float(diff.mean() / full.abs().mean())}


def _ssm_continuation(torch, model, queries, tokenizer) -> dict:
    """mamba2 at full width: greedy tokens of ``decode_step`` after a
    prefill (the recurrence) against ``forward`` over the extended
    sequence (the chunked scan). In bf16 the two round apart layer after
    layer, so tokens may differ at near-ties only; an f32 twin with the
    same weights must agree within ``CONTINUATION_F32_REL`` of its largest
    logit (a wrong conv or SSD state moves them by their whole range)."""
    import dataclasses
    from repro_torch.models.model import Model
    toks, _ = tokenizer.encode_batch(queries, PROMPT)
    tokens = torch.as_tensor(toks, dtype=torch.long, device="cuda")
    twin = Model(dataclasses.replace(model.config, dtype="float32"),
                 device="cuda")
    twin.load_state_dict(model.state_dict())           # cast to f32
    res = {"rows": len(toks), "steps": CONTINUATION_STEPS + 1,
           "bf16": _continuation(torch, model, tokens),
           "f32": _continuation(torch, twin, tokens),
           "f32_max_rel_bound": CONTINUATION_F32_REL}
    del twin
    emit("model_families", check="mamba2 full width: decode continues the "
         "forward", **res)
    for dtype in ("bf16", "f32"):
        if res[dtype]["unexplained_differences"]:
            fail(f"mamba2 {dtype}: decode after prefill and forward "
                 f"disagree on a greedy token with no near-tie: {res}")
    if res["f32"]["max_rel"] > CONTINUATION_F32_REL:
        fail(f"mamba2 f32: decode after prefill and forward differ by "
             f"{res['f32']['max_rel']} of the largest logit")
    return res


def _model_serve(torch, arch, n_layers, sim_cached, batches=FAMILY_BATCHES,
                 phase="model_families") -> dict:
    """``arch`` at full width (``n_layers`` layers, or all) behind the main
    configuration for ``batches`` batches: launches per batch with misses,
    finite logits, every hit decision equal to the sim backend's in the
    main phase, the backend wall split into prefill and decode, one
    generate under ``torch.profiler``; the first miss batch again through
    the plain attention (``VS_PLAIN``), mamba2's decode continuing its
    forward."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng, reqs = serve.build(device="cuda", backend="model", arch=arch,
                            reduced=False, n_layers=n_layers,
                            log=lambda *a: None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = eng.backend.model
    cfg = model.config
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    reqs = reqs[:batches * eng.batcher.batch_size]
    rec = _Recorder(torch, eng.backend)
    _reset_launches()
    t0 = time.perf_counter()
    resp = eng.process(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    rec.restore()
    with_misses = len(rec.calls)
    layers = _attention_layers(cfg)
    _expect_launches(launches, {
        "cosine_topk": batches,
        "flash_attention": 2 * layers * with_misses,
        "decode_attention": DECODE_PER_STEP_LAYERS * layers * with_misses},
        f"full-width {arch} serving")
    if len(resp) != len(reqs) or not rec.all_finite():
        fail(f"full-width {arch}: missing responses or a non-finite logit")
    cached = [r.cached for r in resp]
    if cached != sim_cached[:len(reqs)]:
        fail(f"full-width {arch}: hit decisions differ from the sim "
             "backend's")
    misses = [c["misses"] for c in rec.calls]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "param_count": cfg.param_count(),
           "reduced": None if n_layers is None else {
               "n_layers": [n_layers, get_arch(arch).n_layers]},
           "d_model": cfg.d_model, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "experts": cfg.n_experts, "topk": cfg.moe_topk,
           "ssm_state": cfg.ssm_state, "meta_tokens": cfg.n_meta_tokens,
           "vocab": cfg.vocab, "dtype": cfg.dtype,
           "param_bytes": param_bytes,
           "card_memory_peak": torch.cuda.max_memory_allocated(),
           "build_s": build_s, "requests": len(resp),
           "batches": batches, "batches_with_misses": with_misses,
           "misses_per_batch": misses, "hits": len(resp) - sum(misses),
           "kernel_launches": launches, "all_logits_finite": True,
           "decisions_equal_sim": True,
           "table1_hits": {c: m["cache_hits"] for c, m in
                           eng.metrics.summary()["categories"].items()},
           "wall_s": wall,
           "wall_per_batch_s": wall / batches,
           "serve_path_s": eng.metrics.cache_path_time_s,
           "generate_s_per_batch": [c["generate_s"] for c in rec.calls],
           "prefill_s_per_batch": [c["prefill_s"] for c in rec.calls],
           "decode_s_per_batch": [c["decode_s"] for c in rec.calls]}
    emit(phase, check=f"full-width {arch} serving", **out)
    # the last miss batch: the first also meets cuBLAS's first choice of
    # kernels for these shapes (grok-1: 0.9 s of prefill on an H100)
    emit(phase, check=f"device time of one generate, {arch} (last miss "
         "batch)", **_profile_generate(torch, eng.backend, rec.calls[-1]))
    first = rec.calls[0]["queries"]
    if arch in VS_PLAIN:
        out["vs_plain"] = _kernels_vs_plain(
            torch, model, first, eng.backend.tokenizer, arch, phase)
    if not cfg.has_attention:
        out["continuation"] = _ssm_continuation(torch, model, first,
                                                eng.backend.tokenizer)
    del eng, model, rec
    _free_card(torch)
    return out


def _sink_timing(torch, card: str, b: int) -> dict:
    """Row 9 with sinks at hymba's serve shape (B rows, 128 meta tokens +
    the 64-token prompt = 192 positions, 25/5 heads of 64, window 1,024,
    128 sinks): the kernel, its plain version and SDPA with the same
    visibility as a boolean mask, each also from a CUDA graph."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    l, h, hkv, d, window, sink = 192, 25, 5, 64, 1024, 128
    gen = torch.Generator(device="cuda").manual_seed(53)
    q, k, v = _attn_inputs(torch, gen, ((b, l, h, d), (b, l, hkv, d),
                                        (b, l, hkv, d)), torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qp = torch.arange(l, device="cuda")[:, None]
    kp = torch.arange(l, device="cuda")[None, :]
    mask = (kp <= qp) & ((kp > qp - window) | (kp < sink))
    kw = dict(window=window, n_sink=sink)
    row = _attn_turns(torch, {
        "kernel": lambda: flash_attention_cuda(q, k, v, **kw),
        "plain": lambda: ref.flash_attention_ref(q, k, v, **kw),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)}, 100)
    pairs = int(mask.sum())
    bound = _bound(4.0 * d * h * b * pairs,
                   2 * q.numel() * 2 + 2 * k.numel() * 2, PEAK_BF16_FLOPS)
    out = {**row, **bound, "visible_pairs": pairs,
           "share_of_bound": bound["bound_ms"] / row["graph_ms"]}
    emit("timing", kernel="flash_attention", shape="hymba_sinks", B=b, L=l,
         H=h, HKV=hkv, D=d, window=window, n_sink=sink, dtype="bf16",
         causal=True, card=card, **out)
    return out


def phase_model_families(torch, card: str, sim_cached: list) -> dict:
    """The moe, ssm and hybrid families: each at full width behind the
    main configuration (grok-1 and llama4 at two layers), its hit
    decisions the sim backend's; the kernels against the plain attention
    for grok-1 and hymba; mamba2's decode continuing its forward; each
    reduced family card vs CPU; row 9 timed with sinks."""
    runs = {arch: _model_serve(torch, arch, n, sim_cached)
            for arch, n in FAMILIES}
    for arch, _ in FAMILIES:
        _reduced_card_vs_cpu(torch, arch)
    launches = {name: sum(r["kernel_launches"][name] for r in runs.values())
                for name in ("cosine_topk", "flash_attention",
                             "decode_attention")}
    hymba = runs["hymba-1.5b"]["misses_per_batch"]
    b = max(1, round(sum(hymba) / len(hymba)))
    return {"launches": launches, "sink_timing": _sink_timing(torch, card, b)}


# --------------------------------------------------------------------- #
# the audio and vlm families
# --------------------------------------------------------------------- #
MODALITY_BATCHES = 3        # of the main configuration's 16 (qwen2-vl)
AUDIO_BATCH = 4             # musicgen: sequences generated at once
AUDIO_FRAMES = 60           # EnCodec frames of each prompt (delayed: +3)
AUDIO_NEW = 16              # greedy decode steps after the prefill


def _audio_inputs(torch, cfg, b: int, frames: int, seed: int):
    """Delayed codebook tokens (B, frames + C - 1, C) from random frames
    (``data.audio_delay.apply_delay``, pad 0) and the stub conditioning
    frames (B, n_prefix, d) in the model's dtype, on the card."""
    import numpy as np
    from repro_torch.data.audio_delay import apply_delay
    rng = np.random.default_rng(seed)
    grid = rng.integers(1, cfg.vocab, (b, frames, cfg.n_codebooks))
    toks = torch.as_tensor(apply_delay(grid), dtype=torch.long,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pre = torch.randn((b, cfg.n_prefix, cfg.d_model), generator=gen,
                      device="cuda")
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return toks, pre.to(dt)


def _audio_generate(torch, model, toks, pre, new: int, forced=None):
    """Prefill behind the prefix, then ``new`` greedy decode steps on (B,
    1, C) tokens (``forced``: teacher forcing with another run's tokens).
    Returns the prefill logits, the first decode step's logits, the
    (B, new + 1, C) tokens and the prefill and decode seconds."""
    l = toks.shape[1] + pre.shape[1]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model(toks, prefix_emb=pre, collect_cache=True,
                               cache_size=l + new + 8)
        nt = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, first = [nt], None
        for i in range(new):
            feed = out[-1] if forced is None else forced[:, i:i + 1]
            dl, caches = model.decode_step(caches, feed)
            first = dl if first is None else first
            out.append(torch.argmax(dl, dim=-1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return logits, first, torch.cat(out, dim=1), t1 - t0, t2 - t1


def _audio_run(torch) -> dict:
    """musicgen-large at full width (bf16, all 48 layers) with its 64-slot
    conditioning prefix: a prefill of delayed codebook tokens and
    ``AUDIO_NEW`` greedy decode steps, the kernels' launches counted,
    every logit finite and its padding columns -1e9; the same run again
    through the plain attention fed the kernel run's tokens (bf16 bounds
    of yi-6b, an f32 twin held to ``TWIN_F32_REL``); the reduced model
    card vs CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("musicgen-large")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    toks, pre = _audio_inputs(torch, cfg, AUDIO_BATCH, AUDIO_FRAMES, 71)
    _reset_launches()
    logits, first, gen, prefill_s, decode_s = _audio_generate(
        torch, model, toks, pre, AUDIO_NEW)
    launches = _launches()
    _expect_launches(launches, {
        "flash_attention": cfg.n_layers,
        "decode_attention": AUDIO_NEW * cfg.n_layers},
        "full-width musicgen-large generation")
    c, vp = cfg.n_codebooks, cfg.padded_vocab
    if logits.shape != (AUDIO_BATCH, toks.shape[1], c, vp) or \
            first.shape != (AUDIO_BATCH, 1, c, vp) or \
            not bool(torch.isfinite(logits).all() & torch.isfinite(first)
                     .all()) or not bool((logits[..., cfg.vocab:] == -1e9)
                                         .all()):
        fail("full-width musicgen-large: logits of the wrong shape, "
             "non-finite, or padding columns not -1e9")
    gaps = {}
    for name, m in (("bf16", model), ("f32_twin", None)):
        if m is None:
            m = Model(dataclasses.replace(cfg, dtype="float32"),
                      device="cuda")
            m.load_state_dict(model.state_dict())       # cast to f32
            pre_m = pre.float()
            ref_run = _audio_generate(torch, m, toks, pre_m, 1,
                                      forced=gen)
        else:
            pre_m, ref_run = pre, (logits, first)
        undo = _plain_attention()
        try:
            p_logits, p_first, *_ = _audio_generate(torch, m, toks, pre_m, 1,
                                                    forced=gen)
        finally:
            undo()
        gaps[name] = {
            "prefill_logits": _logit_gap(ref_run[0], p_logits, cfg.vocab),
            "first_decode_logits": _logit_gap(ref_run[1], p_first,
                                              cfg.vocab)}
        if m is not model:
            del m
            _free_card(torch)
    for key in ("prefill_logits", "first_decode_logits"):
        g, t = gaps["bf16"][key], gaps["f32_twin"][key]
        if not (g["max_rel"] <= MODEL_LOGIT_REL
                and g["mean_rel"] <= MODEL_LOGIT_MEAN_REL):
            fail(f"full-width musicgen-large {key}: kernels vs plain "
                 f"attention {g}")
        if t["max_rel"] > TWIN_F32_REL:
            fail(f"full-width musicgen-large f32 twin {key}: kernels vs "
                 f"plain attention {t}")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "param_count": cfg.param_count(), "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "codebooks": c, "n_prefix": cfg.n_prefix,
           "dtype": cfg.dtype, "batch": AUDIO_BATCH, "frames": AUDIO_FRAMES,
           "delayed_tokens": toks.shape[1],
           "prefill_positions": toks.shape[1] + cfg.n_prefix,
           "decode_steps": AUDIO_NEW, "build_s": build_s,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_s_per_step": decode_s / AUDIO_NEW,
           "card_memory_peak": torch.cuda.max_memory_allocated(),
           "kernel_launches": launches, "all_logits_finite": True,
           "vs_plain": gaps,
           "tolerance": {"max_rel": MODEL_LOGIT_REL,
                         "mean_rel": MODEL_LOGIT_MEAN_REL,
                         "f32_twin_max_rel": TWIN_F32_REL}}
    emit("model_modalities", check="full-width musicgen-large generation",
         **out)
    del model
    _free_card(torch)
    out["reduced_card_vs_cpu"] = _audio_reduced_card_vs_cpu(torch)
    return out


def _audio_reduced_card_vs_cpu(torch) -> dict:
    """The reduced musicgen (f32) on the card and the CPU with the same
    weights: prefill behind the prefix and three decode steps, logits
    within 1e-4."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    cfg = get_arch("musicgen-large").reduced()
    card = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in card.state_dict().items()})
    toks, pre = _audio_inputs(torch, cfg, 3, 20, 73)
    a = _audio_generate(torch, card, toks, pre, 3)
    with torch.inference_mode():
        lc, cc = cpu(toks.cpu(), prefix_emb=pre.cpu(), collect_cache=True,
                     cache_size=toks.shape[1] + cfg.n_prefix + 11)
        worst = float((a[0].cpu() - lc).abs().max())
        for i in range(3):
            dc, cc = cpu.decode_step(cc, a[2][:, i:i + 1].cpu())
            if i == 0:
                worst = max(worst, float((a[1].cpu() - dc).abs().max()))
    if worst > 1e-4:
        fail(f"reduced musicgen card vs cpu: logits differ by {worst}")
    out = {"max_abs_logit_diff": worst, "tolerance": 1e-4}
    emit("model_modalities", check="reduced musicgen-large f32, card vs cpu",
         **out)
    return out


def phase_model_modalities(torch, card: str, sim_cached: list) -> dict:
    """qwen2-vl-2b at full width (bf16, all 28 layers) behind the main
    configuration for ``MODALITY_BATCHES`` batches, text only (its hit
    decisions the sim backend's, the kernels against the plain attention),
    the reduced qwen2-vl card vs CPU; musicgen-large at full width with
    its prefix (``_audio_run``)."""
    vlm = _model_serve(torch, "qwen2-vl-2b", None, sim_cached,
                       batches=MODALITY_BATCHES, phase="model_modalities")
    _reduced_card_vs_cpu(torch, "qwen2-vl-2b")
    audio = _audio_run(torch)
    launches = {name: vlm["kernel_launches"][name]
                + audio["kernel_launches"].get(name, 0)
                for name in ("cosine_topk", "flash_attention",
                             "decode_attention")}
    return {"launches": launches, "vlm": vlm, "audio": audio}


# --------------------------------------------------------------------- #
# training on the card: the flash-attention backward (row 9b), one step's
# gradients through the kernels against plain attention, AdamW steps
# --------------------------------------------------------------------- #
# the backward kernel sums f32 products in another order than its plain
# version (f32); a bf16 gradient is that sum rounded once, from operands
# and an output the plain version reads in f32 as they are
BWD_TOL = {"f32": 1e-4, "bf16": 2e-2}   # of the largest |gradient|
LSE_TOL = 1e-4                          # the forward's row log-sum-exp
BWD_CASES = [  # (B, Lq, Lk, H, HKV, D, causal, window, n_sink)
    (2, 128, 128, 4, 4, 64, True, None, 0),      # G=1, causal
    (2, 100, 100, 8, 2, 128, True, None, 0),     # G=4, ragged
    (1, 256, 256, 10, 2, 64, True, 70, 0),       # G=5, window drops keys
    (1, 300, 300, 12, 2, 128, True, 50, 128),    # G=6, sinks span tiles
    (2, 192, 192, 25, 5, 64, True, 1024, 128),   # hymba's shape, G=5
    (2, 64, 200, 6, 1, 128, True, 90, 70),       # Lk > Lq with sinks, G=6
    (1, 100, 60, 4, 2, 64, True, None, 0),       # Lk < Lq: 40 rows see nothing
    (2, 96, 96, 4, 2, 64, False, None, 0),       # not causal
    (8, 128, 128, 12, 2, 128, True, None, 0),    # qwen2-vl's training step
    (2, 128, 128, 32, 32, 64, True, None, 0),    # musicgen's geometry, G=1
    (3, 200, 200, 12, 2, 128, True, 90, 70),     # sliced dK/dV (S > 1), sinks
    (4, 192, 192, 32, 32, 64, True, None, 0),    # musicgen's step: one slice
]


def _grad_err(torch, got, want, tol_share, where) -> float:
    """max |got - want| (both read in f32), which must stay within
    ``tol_share`` of the largest |want|."""
    torch.cuda.synchronize()
    a, b = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(a).all()):
        fail(f"{where}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or "
             "a non-finite gradient")
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    if err > tol_share * max(scale, 1e-30):
        fail(f"{where}: kernel and plain version differ by {err}, over "
             f"{tol_share} of the largest |gradient| {scale}")
    return err


def _flash_bwd_cases(torch) -> dict:
    """Row 9b against its plain version in f32 on the same inputs (the
    kernel's bf16 operands and output read in f32), over causal, window,
    sinks, G = 1, 4, 5, 6, D = 64 and 128, ragged lengths, Lk > Lq and
    rows that see nothing (zero gradient), f32 and bf16; the forward's
    log-sum-exp against the plain one, its output bit for bit the output
    without it; each backward run twice, bit for bit the same (no
    atomics, the slices' partials summed in order). Prints each case's
    plan: the slices S of a key tile's work and the dK/dV grid. Fails
    unless the cases take both ways of writing dK and dV on this card: one
    slice (straight to dK and dV) and several (partials, then their sum)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as kflash
    worst = {"f32": 0.0, "bf16": 0.0}
    lse_worst = 0.0
    torch_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {kflash.bwd_plan(*case[:6], n_sm).splits for case in BWD_CASES}
    if 1 not in splits or max(splits) == 1:
        fail(f"BWD_CASES take slices {sorted(splits)} on {n_sm} SMs: one "
             "slice and several must both be checked")
    for dtype in ("f32", "bf16"):
        gen = torch.Generator(device="cuda").manual_seed(61)
        for b, lq, lk, h, hkv, d, causal, window, sink in BWD_CASES:
            where = (f"flash backward {dtype} B={b} Lq={lq} Lk={lk} H={h} "
                     f"HKV={hkv} D={d} causal={causal} window={window} "
                     f"n_sink={sink}")
            plan = kflash.bwd_plan(b, lq, lk, h, hkv, d, n_sm)
            emit("train", case=where, splits=plan.splits,
                 dkdv_blocks=plan.dkdv_blocks, dq_blocks=plan.dq_blocks,
                 scratch_bytes=plan.scratch_bytes)
            q, k, v, dout = _attn_inputs(torch, gen, (
                (b, lq, h, d), (b, lk, hkv, d), (b, lk, hkv, d),
                (b, lq, h, d)), torch_dtype[dtype])
            kw = dict(causal=causal, window=window, n_sink=sink)
            out, lse = kflash.flash_attention_fwd_cuda(q, k, v, **kw)
            plain_out = kflash.flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, plain_out):
                fail(f"{where}: the forward's output moved when it also "
                     "wrote the log-sum-exp")
            f32 = [x.float() for x in (q, k, v)]
            _, want_lse = ref.flash_attention_lse_ref(*f32, **kw)
            seen = torch.isfinite(want_lse)
            if not torch.equal(seen, torch.isfinite(lse)):
                fail(f"{where}: rows that see nothing differ in the lse")
            lse_err = float((lse[seen] - want_lse[seen]).abs().max()) \
                if bool(seen.any()) else 0.0
            if lse_err > LSE_TOL:
                fail(f"{where}: lse differs by {lse_err} (> {LSE_TOL})")
            lse_worst = max(lse_worst, lse_err)
            got = kflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                  **kw)
            again = kflash.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                    **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"{where}: two runs of the backward differ")
            want = ref.flash_attention_bwd_ref(*f32, out.float(),
                                               dout.float(), lse, **kw)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                if g.dtype != q.dtype:
                    fail(f"{where}: {name} is {g.dtype}, not {q.dtype}")
                worst[dtype] = max(worst[dtype], _grad_err(
                    torch, g, w, BWD_TOL[dtype], f"{where} {name}"))
            if not seen.all():   # rows that see no key: zero dq
                dead = ~seen[0, 0]
                if bool(got[0][:, dead].float().abs().max() > 0):
                    fail(f"{where}: a row that sees nothing has a gradient")
        emit("train", kernel="flash_attention_bwd", dtype=dtype,
             cases=len(BWD_CASES), max_abs_err=worst[dtype],
             tol_share_of_max_grad=BWD_TOL[dtype], lse_max_err=lse_worst)
    return {"max_abs_err": max(worst.values()), "lse_max_err": lse_worst}


def _bwd_bound(q, k, visible_pairs: int) -> dict:
    """Row 9b's least time: five GEMM-sized products (S, dP, dV, dQ, dK:
    2 D FLOP each per visible (query, key, head)) at the bf16 tensor-core
    rate, against q, k, v, out, dout and lse read and dq, dk, dv written
    once at the memory rate."""
    b, lq, h, d = q.shape
    e = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * e + b * h * lq * 4 \
        + (q.numel() + 2 * k.numel()) * e
    return _bound(10.0 * d * h * visible_pairs * b, nbytes, PEAK_BF16_FLOPS)


def _sdpa_bwd(torch, q, k, v, out_grad):
    """SDPA's backward as one ATen call a CUDA graph can capture (causal,
    q (B, L, H, D), k and v (B, L, HKV, D)): the flash backend's forward
    once, for its output, log-sum-exp and RNG state, then a callable of
    ``_scaled_dot_product_flash_attention_backward`` over (B, H, L, D)
    views with k and v expanded to H heads (the op takes no grouped heads;
    the expansion and the group's sum of dK and dV are left out). A
    yardstick the port never calls."""
    aten = torch.ops.aten
    g = q.shape[2] // k.shape[2]
    qt, dot = q.transpose(1, 2), out_grad.transpose(1, 2)
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    o, lse, cq, ck, mq, mk, seed, offset = \
        aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)[:8]
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset)


def _flash_bwd_timing(torch, card: str, shape: tuple) -> dict:
    """Row 9b at a training step's shape (bf16, causal): the backward
    kernel, its plain version and SDPA's backward (a yardstick the port
    never calls), timed in turns by events, and the kernel and SDPA's
    backward (``_sdpa_bwd``, one ATen call) from CUDA graphs; SDPA's
    backward through autograd by events beside them (the autograd engine
    runs it on its own thread, which a graph cannot capture); row 9's
    forward with and without the log-sum-exp; the backward's plan."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as kflash
    b, l, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(67)
    q, k, v, dout = _attn_inputs(torch, gen, (
        (b, l, h, d), (b, l, hkv, d), (b, l, hkv, d), (b, l, h, d)),
        torch.bfloat16)
    out, lse = kflash.flash_attention_fwd_cuda(q, k, v)
    f32 = [x.float() for x in (q, k, v, out, dout)]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True)
    sdpa_dout = dout.transpose(1, 2)
    library = _sdpa_bwd(torch, q, k, v, dout)
    kernel = lambda: kflash.flash_attention_bwd_cuda(q, k, v, out, dout,  # noqa: E731
                                                     lse)
    ms, times = _time_turns(torch, {
        "kernel": kernel,
        "plain": lambda: ref.flash_attention_bwd_ref(*f32, lse),
        "autograd": lambda: torch.autograd.grad(
            sdpa, (qt, kt, vt), sdpa_dout, retain_graph=True)}, 50)
    graph = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        graph[name].append(_time_graph(
            torch, kernel if name == "kernel" else library, 50))
    row = {"kernel_ms": ms["kernel"], "graph_ms": min(graph["kernel"]),
           "plain_ms": ms["plain"], "library_ms": min(graph["library"]),
           "library_timed": "graph of aten._scaled_dot_product_flash_"
           "attention_backward, k and v expanded to H heads",
           "library_autograd_ms": ms["autograd"],
           "library_autograd_fn": sdpa.grad_fn.name(), "runs_ms": times,
           "graph_runs_ms": graph}
    pairs = l * (l + 1) // 2
    bound = _bwd_bound(q, k, pairs)
    plan = kflash.bwd_plan(b, l, l, h, hkv, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    out = {**row, **bound, "visible_pairs": pairs,
           "share_of_bound": bound["bound_ms"] / row["graph_ms"],
           "plan": plan._asdict(), "forward": _lse_timing(torch, q, k, v)}
    emit("timing", kernel="flash_attention_bwd", shape="train", B=b, L=l,
         H=h, HKV=hkv, D=d, dtype="bf16", causal=True, card=card, **out)
    return out


def _lse_timing(torch, q, k, v) -> dict:
    """Row 9's forward from CUDA graphs without and with the log-sum-exp
    written (the serve path's form and the training form), in turns
    (without, with, with, without; best of two)."""
    from repro_torch.kernels import flash_attention as kflash
    fns = {"without_lse": lambda: kflash.flash_attention_cuda(q, k, v),
           "with_lse": lambda: kflash.flash_attention_fwd_cuda(q, k, v)}
    runs = {name: [] for name in fns}
    for name in ("without_lse", "with_lse", "with_lse", "without_lse"):
        runs[name].append(_time_graph(torch, fns[name], 100))
    return {"graph_ms": {n: min(t) for n, t in runs.items()},
            "graph_runs_ms": runs}


def _serve_shape_lse_timing(torch, card: str) -> dict:
    """Row 9 at the serve path's prefill shape (B=40, L=64, 32/4 heads of
    128, bf16, causal) without and with the log-sum-exp."""
    gen = torch.Generator(device="cuda").manual_seed(69)
    q, k, v = _attn_inputs(torch, gen, ((40, 64, 32, 128), (40, 64, 4, 128),
                                        (40, 64, 4, 128)), torch.bfloat16)
    out = _lse_timing(torch, q, k, v)
    emit("timing", kernel="flash_attention", shape="serve, with and without "
         "the log-sum-exp", B=40, L=64, H=32, HKV=4, D=128, dtype="bf16",
         card=card, **out)
    return out


TRAIN_STEPS = 10            # launch.train --arch qwen2-vl-2b --full
TRAIN_BATCH, TRAIN_SEQ = 8, 128   # launch.train's defaults
AUDIO_TRAIN_STEPS = 6       # musicgen-large through loss_fn, one batch
# launch.train's 3e-3 overshoots at 48 layers of width 2,048 (the loss rose
# at the third step on an H100: 8.13, 7.66, 8.45); at 5e-4 it falls each
# step (8.13 to 5.45 in six)
AUDIO_TRAIN_LR = 5e-4
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_FRAMES = 4, 125   # 128 delayed positions
GRAD_CHECK_LAYERS = 4       # the kernels-vs-plain step: qwen2-vl, f32
GRAD_SHARE = 1e-3           # of each leaf's largest |gradient|
LOSS_FALL = 0.8             # the last loss under this share of the first


def _grads_vs_plain(torch) -> dict:
    """One training step's loss and every parameter gradient of qwen2-vl
    at full width in f32 (``GRAD_CHECK_LAYERS`` layers: the f32 model's
    weights and moments need not fit beside it), through the kernels
    (forward with the log-sum-exp, backward kernel) against the same step
    through the plain attention (autograd through
    ``ref.flash_attention_ref``) on the same weights and tokens; ``wq``'s
    gradient is not zero."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data.qa_dataset import build_corpus
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.launch.train import make_batches
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch("qwen2-vl-2b"), dtype="float32",
                              n_layers=GRAD_CHECK_LAYERS)
    model = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(True)
    toks = torch.as_tensor(next(make_batches(
        HashTokenizer(vocab_size=cfg.vocab), build_corpus(500), TRAIN_BATCH,
        TRAIN_SEQ, cfg.vocab)), dtype=torch.long, device="cuda")
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        kflash.reset_launches()
        undo = _plain_attention() if plain else (lambda: None)
        try:
            loss = model.loss_fn(toks)
            loss.backward()
        finally:
            undo()
        torch.cuda.synchronize()
        # prefix_proj takes no part in text-only training: no gradient
        runs.append((float(loss.detach()), dict(kflash.launches),
                     {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None}))
    (k_loss, k_launch, k_grads), (p_loss, p_launch, p_grads) = runs
    if k_launch["flash_attention_bwd"] != cfg.n_layers or \
            p_launch["flash_attention_bwd"] != 0:
        fail(f"kernels-vs-plain step: backward launches {k_launch} (kernels)"
             f", {p_launch} (plain)")
    if set(k_grads) != set(p_grads):
        fail("kernels-vs-plain step: the two runs reached other leaves")
    worst = {}
    for name, want in p_grads.items():
        err = float((k_grads[name] - want).abs().max())
        scale = float(want.abs().max())
        worst[name] = err / max(scale, 1e-30)
        if err > GRAD_SHARE * max(scale, 1e-30) or not bool(
                torch.isfinite(k_grads[name]).all()):
            fail(f"kernels-vs-plain step: {name}'s gradient differs by {err}"
                 f" (largest |gradient| {scale})")
    if float(k_grads["blocks.wq"].abs().max()) == 0.0 or \
            abs(k_loss - p_loss) > 1e-4 * abs(p_loss):
        fail(f"kernels-vs-plain step: wq's gradient is zero or the losses "
             f"differ ({k_loss} vs {p_loss})")
    out = {"arch": cfg.name, "dtype": "float32", "n_layers": cfg.n_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "loss_kernels": k_loss,
           "loss_plain": p_loss, "launches_kernels": k_launch,
           "worst_leaf_share": max(worst.values()),
           "worst_leaf": max(worst, key=worst.get),
           "wq_grad_max": float(k_grads["blocks.wq"].abs().max()),
           "tolerance_share": GRAD_SHARE, "leaves": len(worst)}
    emit("train", check="one step's gradients, kernels vs plain attention",
         **out)
    del model, k_grads, p_grads
    _free_card(torch)
    return out


def _train_qwen2(torch) -> dict:
    """``launch.train --arch qwen2-vl-2b --full``: AdamW for
    ``TRAIN_STEPS`` steps at full width (bf16 weights, f32 moments, remat
    "full") on a fixed batch, launch.train's first (8 x 128 tokens of the QA
    corpus; its sampler repeats that draw here); every loss finite, the
    last under ``LOSS_FALL`` of the first; seconds a step after the
    first."""
    import itertools
    from repro_torch.launch import train
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    times = []
    sampler = train.make_batches   # a fixed batch: the sampler's first
    train.make_batches = lambda *a, **kw: itertools.repeat(next(sampler(
        *a, **kw)))

    def log(line):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
    t0 = time.perf_counter()
    try:
        out = train.train("qwen2-vl-2b", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, full=True, log_every=1, log=log,
                          device="cuda")
    finally:
        train.make_batches = sampler
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = out["loss"]
    step_s = [b - a for a, b in zip(times[1:], times[2:])]
    if not all(math.isfinite(x) for x in losses) or \
            losses[-1] > LOSS_FALL * losses[0]:
        fail(f"qwen2-vl-2b training: losses {losses}")
    res = {"arch": "qwen2-vl-2b", "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "n_layers": out["model"].config.n_layers,
           "params": sum(p.numel() for p in out["model"].parameters()),
           "losses": losses, "lr": out["lr"], "grad_norm": out["grad_norm"],
           "wall_s": wall, "step_s": step_s,
           "step_s_median": sorted(step_s)[len(step_s) // 2],
           "card_memory_peak": torch.cuda.max_memory_allocated()}
    emit("train", check="launch.train --arch qwen2-vl-2b --full", **res)
    del out
    _free_card(torch)
    return res


def _train_musicgen(torch) -> dict:
    """musicgen-large at full width (bf16, all 48 layers) through
    ``Model.loss_fn`` and ``make_train_step`` (AdamW, launch.train's
    settings) for ``AUDIO_TRAIN_STEPS`` steps on one batch of delayed
    codebook tokens behind the 64-slot prefix; the loss falls."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import (AdamWConfig, init_adamw,
                                                make_train_step)
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("musicgen-large")
    model = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(True)
    toks, pre = _audio_inputs(torch, cfg, AUDIO_TRAIN_BATCH,
                              AUDIO_TRAIN_FRAMES, 79)
    named = dict(model.named_parameters())
    opt = init_adamw(named)
    step = make_train_step(
        lambda _p, batch: model.loss_fn(batch[0], prefix_emb=batch[1]),
        AdamWConfig(lr=AUDIO_TRAIN_LR, warmup_steps=1,
                    total_steps=AUDIO_TRAIN_STEPS))
    losses, step_s = [], []
    for _ in range(AUDIO_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        named, opt, metrics = step(named, opt, (toks, pre))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses) or \
            losses[-1] > LOSS_FALL * losses[0]:
        fail(f"musicgen-large training: losses {losses}")
    res = {"arch": cfg.name, "steps": AUDIO_TRAIN_STEPS,
           "n_layers": cfg.n_layers,
           "batch": AUDIO_TRAIN_BATCH, "delayed_tokens": toks.shape[1],
           "positions": toks.shape[1] + cfg.n_prefix,
           "params": sum(p.numel() for p in named.values()),
           "losses": losses, "step_s": step_s,
           "card_memory_peak": torch.cuda.max_memory_allocated()}
    emit("train", check="musicgen-large through loss_fn, full width", **res)
    del model, named, opt
    _free_card(torch)
    return res


def phase_train(torch, card: str) -> dict:
    """Training on the card: row 9b against its plain version, one step's
    gradients through the kernels against plain attention, then the main
    path's training runs (``launch.train`` on qwen2-vl-2b, musicgen-large
    through ``loss_fn``) with the flash kernels' launches counted, and
    row 9b timed at the qwen2-vl step's shape."""
    from repro_torch.kernels import flash_attention as kflash
    cases = _flash_bwd_cases(torch)
    grads = _grads_vs_plain(torch)
    kflash.reset_launches()
    vlm = _train_qwen2(torch)
    audio = _train_musicgen(torch)
    launches = dict(kflash.launches)
    # remat "full" runs each layer's forward twice a step (the forward,
    # then its recomputation in the backward)
    layer_steps = vlm["n_layers"] * TRAIN_STEPS \
        + audio["n_layers"] * AUDIO_TRAIN_STEPS
    want = {"flash_attention": 2 * layer_steps,
            "flash_attention_bwd": layer_steps}
    if launches != want:
        fail(f"training launches {launches}, expected {want}")
    emit("train", check="flash kernel launches in the training runs",
         launches=launches)
    timing = _flash_bwd_timing(torch, card, (TRAIN_BATCH, TRAIN_SEQ, 12, 2,
                                             128))
    # musicgen-large's step: 64 prefix slots and 128 delayed positions,
    # 32 heads of 64
    timing_audio = _flash_bwd_timing(torch, card, (AUDIO_TRAIN_BATCH, 192,
                                                   32, 32, 64))
    return {"launches": launches, "max_err": cases["max_abs_err"],
            "timing": timing, "timing_musicgen": timing_audio,
            "serve_lse": _serve_shape_lse_timing(torch, card),
            "grads": grads, "qwen2": vlm, "musicgen": audio}


# --------------------------------------------------------------------- #
# the last modules: the MiniLM encoder, HNSW and the dry run
# --------------------------------------------------------------------- #
ENCODER_TOL = 1e-5          # card rows vs the CPU's, f32, absolute
ENCODER_BATCH = 128         # the main configuration's batch
HNSW_N, HNSW_QUERIES = 2048, 128   # keys of d=384; noisy queries
HNSW_M, HNSW_EF_CONSTRUCTION = 16, 100   # benchmarks/kernel_bench.py's
HNSW_RECALL = 0.9           # tests/test_index_and_policy.py's bar
DRYRUN_PAIRS = (("mamba2-130m", "decode_32k"), ("yi-6b", "decode_32k"))


def _encoder_tokens(torch):
    """The main configuration's 2,000 test queries as HashTokenizer ids,
    padded to the longest (queries and corpus questions) and capped at
    the encoder's 256 positions; and the queries themselves."""
    from repro_torch.data.qa_dataset import build_corpus, build_test_queries
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.embedding import MINILM_L6
    pairs = build_corpus(2000, seed=0)
    queries = [q.query for q in build_test_queries(pairs, n_per_category=500,
                                                   seed=1)]
    tok = HashTokenizer(vocab_size=MINILM_L6.vocab)
    longest = max(len(tok.encode(t)) for t in
                  queries + [p.question for p in pairs])
    tokens, lens = tok.encode_batch(queries, min(longest, MINILM_L6.max_len))
    return queries, torch.from_numpy(tokens), torch.from_numpy(lens)


def _tools_encoder(torch, card: str) -> dict:
    """MiniLM at full width on the card, 16 batches of 128 queries, held
    row by row against the same weights on the CPU; one batch timed by
    events and from a CUDA graph, beside the host HashEmbedder's time a
    batch over the same queries."""
    from repro_torch.embedding import MINILM_L6, encode, init_encoder_params
    from repro_torch.embedding.hash_embedder import HashEmbedder
    queries, tokens, lens = _encoder_tokens(torch)
    params = init_encoder_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    card_params = {k: ({n: t.cuda() for n, t in v.items()}
                       if isinstance(v, dict) else v.cuda())
                   for k, v in params.items()}
    max_err, batches = 0.0, 0
    with torch.no_grad():
        for lo in range(0, len(queries), ENCODER_BATCH):
            t, n = tokens[lo:lo + ENCODER_BATCH], lens[lo:lo + ENCODER_BATCH]
            got = encode(card_params, t.cuda(), n.cuda()).cpu()
            want = encode(params, t, n)
            if not torch.isfinite(got).all():
                fail(f"encoder batch {batches}: non-finite card rows")
            norms = torch.linalg.vector_norm(got, dim=-1)
            if (norms - 1).abs().max() > 1e-5:
                fail(f"encoder batch {batches}: rows not of unit norm "
                     f"({norms.min():.6f}..{norms.max():.6f})")
            err = float((got - want).abs().max())
            if err > ENCODER_TOL:
                fail(f"encoder batch {batches}: card vs CPU {err:.3g} > "
                     f"{ENCODER_TOL}")
            max_err, batches = max(max_err, err), batches + 1
        t = tokens[:ENCODER_BATCH].cuda()
        n = lens[:ENCODER_BATCH].cuda()
        events_ms = _time(torch, lambda: encode(card_params, t, n), 20)
        graph_ms = _time_graph(torch, lambda: encode(card_params, t, n), 20)
    hash_s = []
    emb = HashEmbedder()
    for lo in range(0, len(queries), ENCODER_BATCH):
        t0 = time.perf_counter()
        emb.embed_batch(queries[lo:lo + ENCODER_BATCH])
        hash_s.append(time.perf_counter() - t0)
    # a batch's products: the projections and the FFN, then the scores and
    # the values over all L keys (the masked ones too)
    cfg, (b, l) = MINILM_L6, t.shape
    d, ff = cfg.d_model, cfg.d_ff
    flops = cfg.n_layers * (2.0 * b * l * (4 * d * d + 2 * d * ff)
                            + 4.0 * b * l * l * d)
    # the blocks' weights, the embedding rows the tokens pick, the
    # position rows, the tokens and lengths read; the pooled rows written
    nbytes = sum(x.nbytes for x in card_params["blocks"].values()) \
        + (b * l + l + 1 + b) * d * 4 + t.nbytes + n.nbytes
    line = {"config": "MINILM_L6", "queries": len(queries),
            "batches": batches, "seq": int(tokens.shape[1]),
            "max_abs_err": max_err, "tol": ENCODER_TOL,
            "batch_ms_events": events_ms, "batch_ms_graph": graph_ms,
            "batch_gflop": flops / 1e9,
            "tflops_graph": flops / graph_ms / 1e9,
            **_bound(flops, nbytes, PEAK_F32_FLOPS),
            "hash_embedder_host_ms_per_batch": 1e3 * sum(hash_s) / len(hash_s),
            "card": card}
    emit("tools", check="MiniLM encoder on the card vs the CPU", **line)
    return line


def _tools_hnsw(torch, card: str) -> dict:
    """The port's HNSWIndex (host) over HNSW_N unit keys, its top-1 for
    noisy queries against ``ops.cosine_topk``'s exact top-1 on the card."""
    import numpy as np
    from repro_torch.core import HNSWIndex
    from repro_torch.kernels import ops
    d = 384
    rng = np.random.default_rng(0)
    keys = rng.normal(size=(HNSW_N, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    queries = keys[:HNSW_QUERIES] + 0.05 * rng.normal(
        size=(HNSW_QUERIES, d)).astype(np.float32)
    idx = HNSWIndex(dim=d, max_elements=HNSW_N, m=HNSW_M,
                    ef_construction=HNSW_EF_CONSTRUCTION, ef_search=64)
    t0 = time.perf_counter()
    for v in keys:
        idx.add(v)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, _ = idx.search_batch(queries, 1)
    search_us = 1e6 * (time.perf_counter() - t0) / HNSW_QUERIES
    q = torch.from_numpy(queries).cuda()
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    _, exact = ops.cosine_topk(q, torch.from_numpy(keys).cuda(),
                               torch.ones(HNSW_N, dtype=torch.bool,
                                          device="cuda"), k=1)
    agreement = float(np.mean(ids[:, 0] == exact[:, 0].cpu().numpy()))
    line = {"n": HNSW_N, "d": d, "m": HNSW_M,
            "ef_construction": HNSW_EF_CONSTRUCTION, "ef_search": 64,
            "queries": HNSW_QUERIES, "agreement_top1": agreement,
            "build_s": build_s, "search_us_per_query": search_us,
            "card": card}
    emit("tools", check="HNSW top-1 vs the exact cosine top-1 on the card",
         **line)
    if agreement < HNSW_RECALL:
        fail(f"HNSW top-1 agreement {agreement} < {HNSW_RECALL}")
    return line


def phase_tools(torch, card: str, scratch: Path) -> dict:
    """The last modules: the MiniLM encoder on the card against the CPU,
    HNSW against the cosine kernel's exact top-1, and the dry run (the
    sharded cache pair on the card, f32 and int8, beside its roofline
    terms; model pairs on ``meta``). Returns the cosine kernel's
    launches."""
    from repro_torch.kernels import cosine_topk as kmod
    from repro_torch.launch import dryrun
    kmod.reset_launches()
    encoder = _tools_encoder(torch, card)
    hnsw = _tools_hnsw(torch, card)
    cache = {}
    for variant in ("", "int8"):
        art = dryrun.run_cache(str(scratch), variant, "cuda", verbose=False)
        if not art["ok"]:
            fail(f"dry run, cache pair {variant or 'f32'}: {art['error']}")
        cache[variant or "f32"] = art
        bound_ms = 1e3 * max(art["roofline"]["compute_s"],
                             art["roofline"]["memory_s"])
        emit("tools", check="dry run: sharded cache pair on the card",
             key_dtype=variant or "f32", step_ms=art["step_ms"],
             bound_ms=bound_ms, step_over_bound=art["step_ms"] / bound_ms,
             step_ms_all=art["step_ms_all"], roofline=art["roofline"],
             slab_bytes=art["slab_bytes"], state_bytes=art["state_bytes"],
             capacity=art["capacity"], batch=art["batch"],
             shards=art["shards"], card=card)
        _free_card(torch)
    pairs = {}
    for arch, shape in DRYRUN_PAIRS:
        art = dryrun.run_one(arch, shape, out_dir=str(scratch),
                             verbose=False)
        if not art["ok"]:
            fail(f"dry run {arch} x {shape} on meta: {art['error']} (op "
                 f"{art['failed_op']})")
        pairs[f"{arch}/{shape}"] = art
        emit("tools", check="dry run on meta", arch=arch, shape=shape,
             seconds=art["seconds"], flops=art["flops"],
             counted_flops=art["counted_flops"], state_bytes=art["state_bytes"],
             fits=art["fits"], roofline=art["roofline"])
    launches = dict(kmod.launches)
    # one search for HNSW; one lookup a shard and step (a warm-up, then the
    # timed steps) for each cache pair
    want = 1 + 2 * (1 + dryrun.CACHE_STEPS) * dryrun.CACHE_SHARDS
    if launches["cosine_topk"] != want or sum(launches.values()) != want:
        fail(f"tools launches {launches}: expected cosine_topk {want} only")
    return {"launches": launches, "encoder": encoder, "hnsw": hnsw,
            "cache": cache, "pairs": pairs}


MESH_ARCH, MESH_LAYERS = "yi-6b", 2   # full width, cut to 2 layers, bf16
MESH_BATCH, MESH_LEN, MESH_NEW = 4, 64, 4
MESH_PAIRS = (("grok-1-314b", "decode_32k", "pod_16x16"),
              ("yi-6b", "train_4k", "pod_16x16"),
              ("yi-6b", "train_4k", "multipod_2x16x16"))
MESH_DRYRUN_S = 300         # the production pairs' subprocesses, at most


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_generate(torch, model, tokens):
    """Prefill, then ``MESH_NEW`` greedy decode steps: every step's logits
    and the caches after the last, as full tensors."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    with torch.no_grad():
        logits, caches = model.forward(
            tokens, collect_cache=True, cache_size=MESH_LEN + MESH_NEW,
            logits_last_only=True)
        out = [full(logits)]
        for _ in range(MESH_NEW):
            nxt = out[-1][:, -1:].argmax(-1).to(torch.int32)
            logits, caches = model.decode_step(caches, nxt)
            out.append(full(logits))
    torch.cuda.synchronize()
    return out, [full(caches.kv.k), full(caches.kv.v)]


def _mesh_one_card(torch) -> dict:
    """(a) The sharded ``Model`` on a (1, 1) mesh of one NCCL rank against
    the unsharded one, bit for bit, the attention kernels launched under
    ``local_map``."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch(MESH_ARCH), n_layers=MESH_LAYERS)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        plain = Model(cfg, device="cuda").init_params(
            torch.Generator(device="cuda").manual_seed(0))
        sharded = Model(cfg, device="cuda", mesh=mesh)
        sharded.load_state_dict(plain.state_dict())
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_LEN),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        _reset_launches()
        got, got_kv = _mesh_generate(torch, sharded, tokens)
        launches = {k: v for k, v in _launches().items() if v}
        want_launches = {"flash_attention": MESH_LAYERS,
                         "decode_attention": MESH_LAYERS * MESH_NEW}
        if launches != want_launches:
            fail(f"mesh (1, 1): launches {launches}, expected "
                 f"{want_launches}: the kernels must run under local_map")
        want, want_kv = _mesh_generate(torch, plain, tokens)
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.isfinite(a).all():
                fail(f"mesh (1, 1): non-finite logits at step {i}")
            if not torch.equal(a, b):
                fail(f"mesh (1, 1): step {i} logits differ from the "
                     f"unsharded model's by {(a - b).abs().max().item()}")
        for a, b in zip(got_kv, want_kv):
            if not torch.equal(a, b):
                fail("mesh (1, 1): the KV caches differ from the unsharded "
                     "model's")
        placements = {n: str(p.placements) for n, p in
                      list(sharded.named_parameters())[:3]}
        del plain, sharded
        _free_card(torch)
    finally:
        dist.destroy_process_group()
    out = {"arch": cfg.name, "n_layers": MESH_LAYERS, "dtype": cfg.dtype,
           "batch": MESH_BATCH, "prefill_len": MESH_LEN,
           "decode_steps": MESH_NEW, "launches": launches,
           "bit_equal_steps": len(got), "placements": placements}
    emit("mesh", check="sharded Model on a (1, 1) NCCL mesh vs unsharded",
         note="checks the mesh code path and the kernels on DTensor inputs "
              "(local_map), not an exchange: NCCL refuses two ranks on one "
              "GPU; the exchanges are held on the CPU by the gloo tests",
         **out)
    return out


def _mesh_dryrun_start(scratch: Path) -> dict:
    """(b) The production dry run in the fake world: each pair in a
    process of its own (``launch.dryrun --mesh``), all started at once;
    ``_mesh_dryrun`` collects them."""
    import os
    return {(arch, shape, mesh): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh,
         "--arch", arch, "--shape", shape, "--out", str(scratch)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for arch, shape, mesh in MESH_PAIRS}


def _mesh_dryrun(procs: dict, scratch: Path) -> dict:
    arts = {}
    for (arch, shape, mesh), proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=MESH_DRYRUN_S)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            fail(f"dry run {arch} x {shape} on {mesh}: over "
                 f"{MESH_DRYRUN_S} s")
        path = scratch / f"{arch}_{shape}_{mesh}.json"
        if proc.returncode != 0 or not path.exists():
            fail(f"dry run {arch} x {shape} on {mesh}: exit "
                 f"{proc.returncode}\n{text[-3000:]}")
        art = json.loads(path.read_text())
        want_chips = 512 if mesh.startswith("multipod") else 256
        if not art["ok"] or art["chips"] != want_chips:
            fail(f"dry run {arch} x {shape} on {mesh}: {art.get('error')}")
        arts[f"{arch}/{shape}/{mesh}"] = art
        emit("mesh", check="production dry run (fake world, meta)",
             arch=arch, shape=shape, mesh=mesh, chips=art["chips"],
             seconds=art["seconds"], param_bytes=art["param_bytes"],
             opt_bytes=art["opt_bytes"], cache_bytes=art["cache_bytes"],
             state_bytes=art["state_bytes"], fits=art["fits"],
             memory=art["memory"],
             collective_bytes=art["collectives"]["bytes"],
             collective_total_bytes=art["collectives"]["total_bytes"],
             dominant=art["roofline"]["dominant"],
             roofline={k: art["roofline"][k] for k in (
                 "compute_s", "memory_s", "collective_s")})
    return arts


def phase_mesh(torch, card: str, scratch: Path) -> dict:
    """The multi-chip path on one card: (c) the cache pair at the pod's 16
    shards on the card, f32 and int8, timed beside its per-chip roofline
    terms, with the host to itself; then (a) the sharded ``Model`` on a
    (1, 1) NCCL mesh bit for bit against the unsharded one, the flash and
    decode kernels launched under ``local_map``, while (b) the production
    dry run (grok-1 decode_32k with the sharded MoE and yi-6b train_4k on
    ``pod_16x16``, yi-6b train_4k on ``multipod_2x16x16``) runs in the
    fake world in processes of its own ((a) times nothing). Returns the
    kernels' launches over the phase."""
    from repro_torch.launch import dryrun
    cache, cache_launches = _mesh_cache(torch, card, scratch, dryrun)
    procs = _mesh_dryrun_start(scratch)
    try:
        one_card = _mesh_one_card(torch)
        pairs = _mesh_dryrun(procs, scratch)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"launches": dict(one_card["launches"], **cache_launches),
            "one_card": one_card, "cache": cache, "pairs": pairs}


def _mesh_cache(torch, card: str, scratch: Path, dryrun) -> tuple:
    """(c) of ``phase_mesh``: the artifacts and the launches."""
    _reset_launches()
    cache = {}
    for variant in ("", "int8"):
        art = dryrun.run_cache(str(scratch), variant, "cuda", verbose=False,
                               mesh_name="pod_16x16")
        if not art["ok"]:
            fail(f"mesh: cache pair {variant or 'f32'} at 16 shards: "
                 f"{art['error']}")
        if art["shards"] != 16 or art["hits_last_step"] != art["batch"]:
            fail(f"mesh: cache pair {variant or 'f32'}: {art['shards']} "
                 f"shards, {art['hits_last_step']} hits of {art['batch']}")
        terms = art["roofline"]
        bound_ms = 1e3 * max(terms["compute_s"], terms["memory_s"],
                             terms["collective_s"])
        cache[variant or "f32"] = art
        emit("mesh", check="cache pair at 16 shards on the card",
             key_dtype=variant or "f32", step_ms=art["step_ms"],
             step_ms_all=art["step_ms_all"], roofline=terms,
             bound_ms_a_chip=bound_ms, collectives=art["collectives"],
             slab_bytes=art["slab_bytes"], shards=art["shards"], card=card)
        _free_card(torch)
    launches = _launches()
    want = 2 * (1 + dryrun.CACHE_STEPS) * 16
    if launches["cosine_topk"] != want or sum(launches.values()) != want:
        fail(f"mesh: cache pair launches {launches}: expected cosine_topk "
             f"{want} only")
    return cache, {"cosine_topk": want}


# --------------------------------------------------------------------- #
def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")

    seconds = {}
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit("phase_seconds", of=name, seconds=seconds[name],
             since_start=time.perf_counter() - t_start)
        return out

    card = timed("card", phase_card, torch)
    timed("build", phase_build)
    max_err = timed("kernel", phase_kernel, torch)
    main_launches, _, main_served, sync = timed("main", phase_main, torch)
    tenancy_launches, tenancy_served = timed("tenancy", phase_tenancy, torch)
    launches = {"cosine_topk": main_launches, **tenancy_launches}
    with tempfile.TemporaryDirectory() as scratch:
        launches["ivf_topk"] = timed("ivf", phase_ivf, torch,
                                     Path(scratch))["ivf_topk"]
    quant_launches, quant_err = timed(
        "quant", phase_quant, torch,
        {"main": main_served, "tenancy": tenancy_served})
    del main_served, tenancy_served
    launches.update(quant_launches)
    for name, err in quant_err.items():
        max_err[name] = max(max_err[name], err)
    sim_cached = [r.cached for r in sync["responses"]]
    timed("serve_async", phase_serve_async, torch, sync)
    ctx_launches = timed("serve_context", phase_serve_context, torch, sync)
    with tempfile.TemporaryDirectory() as scratch:
        sharded_launches = timed("serve_sharded", phase_serve_sharded, torch,
                                 card, sync, Path(scratch))
    del sync
    for name in ("cosine_topk", "cosine_topk_interval"):
        launches[name] += ctx_launches[name]
    for name in ("cosine_topk", "cosine_topk_interval", "ivf_topk"):
        launches[name] += sharded_launches[name]
    timing = timed("timing", phase_timing, torch, card)
    model = timed("model", phase_model, torch, card, sim_cached)
    families = timed("model_families", phase_model_families, torch, card,
                     sim_cached)
    modalities = timed("model_modalities", phase_model_modalities, torch,
                       card, sim_cached)
    train = timed("train", phase_train, torch, card)
    with tempfile.TemporaryDirectory() as scratch:
        tools = timed("tools", phase_tools, torch, card, Path(scratch))
    launches["cosine_topk"] += tools["launches"]["cosine_topk"]
    with tempfile.TemporaryDirectory() as scratch:
        mesh = timed("mesh", phase_mesh, torch, card, Path(scratch))
    launches["cosine_topk"] += mesh["launches"]["cosine_topk"]
    launches["cosine_topk"] += model["launches"]["cosine_topk"] \
        + families["launches"]["cosine_topk"] \
        + modalities["launches"]["cosine_topk"]
    for name in ("flash_attention", "decode_attention"):
        model["launches"][name] += families["launches"][name] \
            + modalities["launches"][name]
    model["launches"]["flash_attention"] += \
        train["launches"]["flash_attention"]
    for name in ("flash_attention", "decode_attention"):
        model["launches"][name] += mesh["launches"][name]
    for mod in ("jax", "repro"):
        if mod in sys.modules:
            fail(f"{mod} was imported")

    # each kernel at the shape of the path that launches it, f32 slab (the
    # quant rows: int8 with per-row scales)
    csrc = "src/repro_torch/kernels/csrc/"
    rows = {"cosine_topk": ((16384, "f32"), "cosine_topk.cu",
                            "src/repro/kernels/cosine_topk.py:218"),
            "cosine_topk_interval":
            ((65536, "f32"), "cosine_topk.cu",
             "src/repro/kernels/cosine_topk.py:251"),
            "cosine_topk_masked":
            ((65536, "f32"), "cosine_topk.cu",
             "src/repro/kernels/cosine_topk.py:286"),
            "ivf_topk": (("serve", "f32"), "ivf_topk.cu",
                         "src/repro/kernels/ivf_topk.py:133"),
            "quant_cosine_topk": ((16384, "quant"), "cosine_topk.cu",
                                  "src/repro/kernels/cosine_topk.py:234"),
            "quant_cosine_topk_interval":
            ((65536, "quant"), "cosine_topk.cu",
             "src/repro/kernels/cosine_topk.py:270"),
            "quant_cosine_topk_masked":
            ((65536, "quant"), "cosine_topk.cu",
             "src/repro/kernels/cosine_topk.py:300")}
    kernels = []
    for name, (shape, source, replaces) in rows.items():
        row = timing[(name, *shape)]
        # a kernel shorter than its wrapper's host time is timed from a
        # CUDA graph of its launches (graph_ms)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": row.get("graph_ms", row["kernel_ms"]),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    for name, source, replaces in (
            ("decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:85"),
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:105")):
        row = model["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "launches": model["launches"][name],
            "max_abs_err": model["max_err"][name], "ms": row["graph_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    row = train["timing"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": csrc + "flash_attention.cu",
        # no TPU kernel: the reference differentiates its jnp
        # blockwise_attention with XLA
        "replaces": "src/repro/models/attention.py:32",
        "launches": train["launches"]["flash_attention_bwd"],
        "max_abs_err": train["max_err"], "ms": row["graph_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    seconds["total"] = time.perf_counter() - t_start
    emit("phase_seconds", of="all", seconds=seconds)
    summary = {"kernels": kernels}
    print(nvidia_smi())
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
