"""One rank of the (2, 2) gloo mesh that ``tests/test_torch_mesh.py``
runs: ``python tests/torch_mesh_worker.py RANK DIR``. It joins a world of
4 ranks through a file store in DIR, reads the inputs the test wrote
there (``inputs.npz``: JAX parameters, tokens, MoE operands), runs the
port's sharded MoE, the sharded ``Model`` of each arch (forward, prefill
and decode), the ``attn`` and ``attn-sp`` variants and three AdamW steps
on the mesh beside the unsharded port, and rank 0 writes every result to
``results.npz``. Not a test module: pytest collects ``test_*.py`` only."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.models.moe import dispatch_indices, moe_ffn, \
    moe_ffn_sharded, router
from repro_torch.training.optimizer import AdamWConfig, adamw_update, \
    init_adamw

ARCHS = {"yi-6b": {}, "grok-1-314b": {},
         # hymba's heads made uneven over the model axis (5 of 64: a
         # projection shard ends mid-head), one KV head
         "hymba-1.5b": {"n_heads": 5, "n_kv_heads": 1}}
PREFILL, DECODE = 32, 4           # tokens (4, PREFILL + DECODE)
# context-parallel decode attention, the cache's S split over ``model``:
# (name, window, n_sink, int8, pos); q (4, 1, 8, 64), caches (4, 64, 2, 64)
# with slots 0..63 holding positions 0..63. "ring" leaves the second half
# of the slots empty (a rank sees nothing: its lse is -inf); "none" sees
# no slot anywhere (the output is 0)
CP_DECODE = (("prefix", None, 0, False, 50), ("int8", None, 0, True, 63),
             ("window_sinks", 16, 4, False, 63),
             ("window_sinks_int8", 16, 4, True, 63),
             ("ring", None, 0, False, 31), ("none", None, 0, False, -1))
ODD_ARCH, ODD = "grok-1-314b", (1, 35)   # a MoE forward of B x L tokens
TRAIN_STEPS = 3
ADAMW = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def config(arch: str):
    return dataclasses.replace(get_arch(arch).reduced(), **ARCHS[arch])


def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach() \
        .numpy()


def _moe(mesh, inputs, out):
    x, wr, wg, wu, wd = (torch.from_numpy(inputs[f"moe_{n}"])
                         for n in ("x", "wr", "wg", "wu", "wd"))
    rep = Replicate()
    placed = (distribute_tensor(x, mesh, [Shard(0), rep], src_data_rank=None),
              distribute_tensor(wr, mesh, [rep, rep], src_data_rank=None),
              distribute_tensor(wg, mesh, [rep, Shard(2)], src_data_rank=None),
              distribute_tensor(wu, mesh, [rep, Shard(2)], src_data_rank=None),
              distribute_tensor(wd, mesh, [rep, Shard(1)], src_data_rank=None))
    fn = moe_ffn_sharded(mesh, ("data",), ("model",))
    for cf in (1.25, 8.0):
        y, aux = fn(*placed, topk=2, capacity_factor=cf)
        out[f"moe_y_{cf}"] = _full(y)
        out[f"moe_aux_{cf}"] = _full(aux)
        out[f"moe_shard_aux_{cf}"] = np.array([float(moe_ffn(
            xs, wr, wg, wu, wd, topk=2, capacity_factor=cf)[1])
            for xs in x.chunk(2)])
        y1, _ = moe_ffn(x, wr, wg, wu, wd, topk=2, capacity_factor=cf)
        out[f"moe_unsharded_{cf}"] = y1.numpy()
    _moe_grads(mesh, (x, wr, wg, wu, wd),
               torch.from_numpy(inputs["moe_cot"]), out)
    # each data shard's expert slots at the local capacity (T/2 tokens)
    for i, xs in enumerate(x.chunk(2)):
        _, experts, _ = router(xs, wr, 2)
        cap = max(int(np.ceil(xs.shape[0] * 2 / wg.shape[0] * 1.25)), 1)
        out[f"moe_slots_{i}"] = dispatch_indices(experts, wg.shape[0],
                                                 cap)[0].numpy()


def _moe_grads(mesh, ops, cot, out):
    """The gradients of sum(y * cot) and of aux into the operands, for the
    tokens split over data ("split") and replicated ("whole"), beside the
    unsharded ``moe_ffn`` of each data shard's tokens (the global aux their
    mean): ``moe_grad_<form>_<cf>_<term>_<operand>_{mesh,plain}``."""
    rep = Replicate()
    for form, x_p in (("split", Shard(0)), ("whole", rep)):
        fn = moe_ffn_sharded(mesh, ("data",) if form == "split" else (),
                             ("model",))
        shards = 2 if form == "split" else 1
        for cf in (1.25, 8.0):
            placed = [distribute_tensor(t, mesh, p, src_data_rank=None)
                      .requires_grad_() for t, p in zip(ops, (
                          [x_p, rep], [rep, rep], [rep, Shard(2)],
                          [rep, Shard(2)], [rep, Shard(1)]))]
            y, aux = fn(*placed, topk=2, capacity_factor=cf)
            cot_d = distribute_tensor(cot, mesh, [x_p, rep],
                                      src_data_rank=None)
            terms = {"y": (y * cot_d).sum().full_tensor(),
                     "aux": aux.full_tensor()}
            plain = [t.clone().requires_grad_() for t in ops]
            parts = [moe_ffn(xs, *plain[1:], topk=2, capacity_factor=cf)
                     for xs in plain[0].chunk(shards)]
            want = {"y": (torch.cat([p[0] for p in parts]) * cot).sum(),
                    "aux": torch.stack([p[1] for p in parts]).mean()}
            for term in terms:
                n = 5 if term == "y" else 2    # aux reaches x and the router
                for name, leaves, loss in (("mesh", placed, terms[term]),
                                           ("plain", plain, want[term])):
                    grads = torch.autograd.grad(loss, leaves[:n],
                                                retain_graph=True)
                    for op, g in zip(("x", "wr", "wg", "wu", "wd"), grads):
                        out[f"moe_grad_{form}_{cf}_{term}_{op}_{name}"] = \
                            _full(g)


def _generate(model, tokens):
    """The full forward's logits, then a prefill of PREFILL tokens and
    DECODE teacher-forced decode steps: (forward, prefill + steps)."""
    with torch.no_grad():
        fwd = _full(model.forward(tokens))
        logits, caches = model.forward(tokens[:, :PREFILL],
                                       collect_cache=True,
                                       cache_size=PREFILL + DECODE
                                       + model.config.n_meta_tokens)
        steps = [_full(logits)]
        for i in range(PREFILL, PREFILL + DECODE):
            logits, caches = model.decode_step(caches, tokens[:, i:i + 1])
            steps.append(_full(logits))
    return fwd, np.concatenate(steps, axis=1)


def _models(mesh, inputs, out):
    tokens = torch.from_numpy(inputs["tokens"])
    for arch in ARCHS:
        state = params_from_jax(json_tree(inputs, arch))
        plain = Model(config(arch), device="cpu")
        plain.load_state_dict(state)
        sharded = Model(config(arch), device="cpu", mesh=mesh)
        sharded.load_state_dict(state)
        for name, model in (("plain", plain), ("mesh", sharded)):
            fwd, dec = _generate(model, tokens)
            out[f"{arch}_{name}_forward"] = fwd
            out[f"{arch}_{name}_decode"] = dec
        out[f"{arch}_placements"] = np.array(json.dumps(
            {n: str(p.placements) for n, p in sharded.named_parameters()}))
        out[f"{arch}_init_mismatch"] = np.array(json.dumps(
            _init_mismatch(mesh, arch)))
        out[f"{arch}_cache_mismatch"] = np.array(json.dumps(_mismatch(
            plain.init_decode_caches(4, PREFILL + DECODE),
            sharded.init_decode_caches(4, PREFILL + DECODE))))
        if arch == ODD_ARCH:    # 35 tokens do not split over 2 data ranks
            with torch.no_grad():
                for name, model in (("plain", plain), ("mesh", sharded)):
                    out[f"odd_{name}"] = _full(model.forward(
                        tokens[:ODD[0], :ODD[1]]))
    state = params_from_jax(json_tree(inputs, "yi-6b"))
    for variant, (attn, sp) in (("attn", (True, False)),
                                ("attn-sp", (True, True))):
        model = Model(config("yi-6b"), device="cpu", mesh=mesh,
                      opt_attn_sharding=attn, opt_seq_parallel=sp)
        model.load_state_dict(state)
        with torch.no_grad():
            out[f"variant_{variant}"] = _full(model.forward(tokens))


def _cp_decode(mesh, inputs, out):
    """Each ``CP_DECODE`` case through ``models.attention.decode_attention``
    with DTensor caches (batch over data, S over model): the mesh output,
    and the unsharded port's."""
    from repro_torch.models import attention as tattn
    q, k, v = (torch.from_numpy(inputs[f"cp_{n}"]) for n in ("q", "k", "v"))
    sp = torch.arange(k.shape[1], dtype=torch.int32)
    for name, window, sink, int8, pos in CP_DECODE:
        ks = vs = None
        kk, vv = k, v
        if int8:
            kk, ks = tattn.quantize_kv(k)
            vv, vs = tattn.quantize_kv(v)
        slots = torch.where(sp < 32, sp, -1) if name == "ring" else sp
        kw = dict(window=window, n_sink=sink)
        plain = tattn.decode_attention(q, kk, vv, slots, pos, k_scale=ks,
                                       v_scale=vs, **kw)

        def put(x, placements):
            return None if x is None else distribute_tensor(x, mesh,
                                                            placements)
        cache_p, q_p = [Shard(0), Shard(1)], [Shard(0), Replicate()]
        got = tattn.decode_attention(
            put(q, q_p), put(kk, cache_p), put(vv, cache_p), slots, pos,
            k_scale=put(ks, cache_p), v_scale=put(vs, cache_p), **kw)
        out[f"cp_{name}_mesh"] = _full(got)
        out[f"cp_{name}_plain"] = _full(plain)


def _init_mismatch(mesh, arch) -> list[str]:
    """The parameters whose init on the mesh differs from the unsharded
    init's from the same seed, in each threefry mode (a rank draws its
    rows at their offset in the leaf's whole draw, which the original
    mode pairs by the whole draw's size), named ``mode:parameter``."""
    bad = []
    for flag in (True, False):
        with prng.partitionable(flag):
            plain, sharded = (
                Model(config(arch), device="cpu", **kw).init_params(
                    prng.key(3)) for kw in ({}, {"mesh": mesh}))
        want = dict(plain.named_parameters())
        bad += [f"{'partitionable' if flag else 'original'}:{n}"
                for n, p in sharded.named_parameters()
                if not torch.equal(p.full_tensor(), want[n])]
    return bad


def _mismatch(want, got) -> list[str]:
    """The fields of two ``DecodeCaches`` that differ (got on the mesh)."""
    bad = []
    for part in ("kv", "ssm"):
        a, b = getattr(want, part), getattr(got, part)
        if (a is None) != (b is None):
            bad.append(part)
            continue
        for f in ("k", "v", "k_scale", "v_scale", "slot_pos", "conv", "ssd"):
            x, y = getattr(a, f, None), getattr(b, f, None)
            if x is None and y is None:
                continue
            y = y.full_tensor() if isinstance(y, DTensor) else y
            if x is None or y is None or not torch.equal(x, y):
                bad.append(f"{part}.{f}")
    return bad


def _train(mesh, inputs, out):
    tokens = torch.from_numpy(inputs["tokens"])
    state = params_from_jax(json_tree(inputs, "yi-6b"))
    for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        model = Model(config("yi-6b"), device="cpu", **kw)
        model.load_state_dict(state)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        opt = init_adamw(params)
        losses, norms = [], []
        for _ in range(TRAIN_STEPS):
            with model.mesh_context():
                loss = model.loss_fn(tokens, remat=True)
                grads = torch.autograd.grad(loss, list(params.values()))
                params, opt, metrics = adamw_update(
                    ADAMW, params, dict(zip(params, grads)), opt)
            losses.append(float(_full(loss)))
            norms.append(float(metrics["grad_norm"]))
        out[f"train_{name}_loss"] = np.array(losses)
        out[f"train_{name}_grad_norm"] = np.array(norms)


def json_tree(inputs, arch: str) -> dict:
    """The JAX parameter tree of ``arch`` from its flattened npz keys
    (``<arch>/blocks/ssm/in_proj`` -> nested dicts)."""
    tree: dict = {}
    for key in inputs.files:
        if not key.startswith(arch + "/"):
            continue
        node = tree
        parts = key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = inputs[key]
    return tree


def main(rank: int, root: Path) -> None:
    dist.init_process_group("gloo", init_method=f"file://{root / 'store'}",
                            rank=rank, world_size=4)
    try:
        mesh = make_local_mesh(2, 2)
        inputs = np.load(root / "inputs.npz")
        out: dict = {}
        _moe(mesh, inputs, out)
        _cp_decode(mesh, inputs, out)
        _models(mesh, inputs, out)
        _train(mesh, inputs, out)
        if rank == 0:
            np.savez(root / "results.tmp.npz", **out)
            (root / "results.tmp.npz").rename(root / "results.npz")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
