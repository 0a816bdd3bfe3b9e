"""The decoder behind the model-backed miss path (PyTorch port of
``repro.models.model``): the dense, moe, ssm, hybrid, audio and vlm
families, for serving and for training.

``Model`` is an ``nn.Module`` whose parameters keep the JAX parameter
tree's names and its stacked per-layer layout: ``embed`` (Vp, d), or
(C, Vp, d) for C > 1 audio codebooks, ``lm_head`` (d, Vp) or (C, d, Vp),
``final_norm`` (d,) f32, ``prefix_proj`` (d, d) where the config takes
frontend embeddings (``n_prefix > 0``: audio and vlm), hymba's
``meta_tokens`` (n_meta, d) and ``blocks.<name>`` with a leading (layer
group, slot) pair of axes, e.g. ``blocks.wq`` (n_groups, interleave, d,
H*hd); the MoE leaves are per group (``blocks.router`` (n_groups, d, E))
and the SSM leaves nest as ``blocks.ssm.<name>``. So
``convert.params_from_jax`` is a renaming, and one ``load_state_dict``
carries the JAX package's weights across.

The families, as in JAX:
  * dense: attention, then a SwiGLU MLP, every layer;
  * moe: a group holds ``moe_interleave`` layers and its last slot's FFN is
    the MoE block (``models/moe.py``; grok: every layer, llama4: every
    second);
  * ssm (mamba2): an SSD block (``models/ssm.py``) and no attention;
  * hybrid (hymba): attention and SSD heads in parallel on the same normed
    input, each branch RMS-normalized and the two averaged, with
    ``n_meta_tokens`` learned registers prepended as attention sinks;
    global attention every ``global_attn_every``-th layer, a sliding
    window elsewhere;
  * audio (musicgen): the ``n_codebooks`` embedding tables summed over a
    (B, L, C) token grid, one head per codebook, (B, L, C, Vp) logits;
  * vlm (qwen2-vl): M-RoPE, and stub frontend embeddings (B, P, d)
    projected by ``prefix_proj`` and prepended at (t=0, h=row, w=col)
    grid positions. musicgen's conditioning frames take the same path.

Three entry points, as in JAX:
  ``forward``      — full-sequence logits, optionally with the prefill's
                     caches or the summed MoE auxiliary loss (attention
                     through the flash-attention kernel on CUDA, sinks
                     included; with operands that require grad, through
                     its autograd Function and the backward kernel);
  ``decode_step``  — one token against the caches (attention through the
                     decode-attention kernel on CUDA; inference only);
  ``loss_fn``      — next-token cross-entropy plus the weighted MoE
                     auxiliary loss, each layer group rematerialized in
                     the backward as ``remat_policy`` says.
The projections, norms, RoPE, MLP, MoE dispatch and expert GEMMs and the
SSD scan are plain PyTorch, as the JAX package leaves them to XLA, with
its rounding points: f32 norms cast back, bf16 residual adds. Where JAX
differentiates its jnp blockwise attention, the port differentiates
through its own kernel's backward.

On a mesh (``Model(config, mesh=...)``, a ``DeviceMesh`` over data and
model axes) the parameters are DTensors placed by
``launch.sharding.param_pspecs``, inputs shard their batch over the data
axes, and the step runs as the unsharded one does, DTensor propagating
the shardings op by op (plain tensors made inside count as replicated)
where the reference leaves them to GSPMD. The reference's sharding
constraints (``opt_attn_sharding``, ``opt_seq_parallel``) become
``redistribute``; the attention kernels run under ``local_map``
(``models/attention.py``) and the MoE slot takes ``moe_ffn_sharded``
where the reference's ``shard_map`` rule sends it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import axis_size as mesh_axis_size
from repro_torch.models.attention import (KVCache, blockwise_attention,
                                          cache_write, decode_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (_branch_norm, positionize, rms_norm,
                                       rope_for, swiglu, unembed)
from repro_torch.models.moe import moe_ffn, moe_ffn_sharded
from repro_torch.models.parallel import vocab_embedding
from repro_torch.models.ssm import (SSMState, init_ssm_state, ssm_decode_step,
                                    ssm_dims, ssm_forward)

REMAT_POLICIES = ("full", "dots", "none")
SSM_LEAVES = ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
              "norm_w", "out_proj")


@dataclasses.dataclass
class DecodeCaches:
    """Everything ``decode_step`` threads through: the KV cache (None for
    the ssm family) and the SSM state (None without SSM layers)."""

    kv: KVCache | None
    ssm: SSMState | None = None


_REPLICATING = False     # DTensor's mode is process-wide, and so is this


@contextlib.contextmanager
def _replicate_plain():
    """DTensor's ``implicit_replication``, entered by the outermost caller
    only: the library's resets the mode to off on exit, which would end an
    enclosing one (a forward inside a training step's)."""
    global _REPLICATING
    if _REPLICATING:
        yield
        return
    _REPLICATING = True
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING = False


def _dtype(config: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


# "dots": the outputs of matmuls without batch dimensions are kept for the
# backward and everything else is recomputed, as JAX's
# ``dots_with_no_batch_dims_saveable`` (x @ W reaches aten as mm / addmm;
# the MoE experts' and the attention's batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def layer_window(config: ModelConfig, li: int) -> int | None:
    """Attention window of layer ``li``, None for global: hybrid configs
    with ``global_attn_every`` are global on every such layer and
    ``sliding_window`` elsewhere; others use ``sliding_window``
    everywhere, or are global. A function of the config alone, so the
    roofline reads it without building a ``Model``."""
    c = config
    if c.arch_type == "hybrid" and c.global_attn_every:
        return None if li % c.global_attn_every == 0 else c.sliding_window
    return c.sliding_window or None


def unembed_multi(logits: torch.Tensor, logical_vocab: int) -> torch.Tensor:
    """The padding columns of per-codebook logits set to -1e9, in place."""
    if logits.shape[-1] > logical_vocab:
        logits[..., logical_vocab:] = -1e9
    return logits


class Model(nn.Module):
    """Config-driven decoder of every family. Its parameters are
    allocated, not drawn: call ``init_params`` (random init) or
    ``load_state_dict`` (e.g. of ``convert.params_from_jax``) before use.
    They do not require grad; a trainer turns that on
    (``requires_grad_(True)``). ``device`` defaults to CUDA and raises
    without it; pass ``device="cpu"`` for the plain path.
    ``remat_policy`` is JAX's: ``"full"`` recomputes each layer group in
    the backward, ``"dots"`` keeps its matmul outputs and recomputes the
    rest, ``"none"`` keeps everything; it applies where ``forward`` is
    called with ``remat=True`` (``loss_fn``'s default) and changes memory,
    never numbers.

    With ``mesh`` (a ``DeviceMesh`` naming ``data_axes`` and
    ``model_axes``; the process group up on every rank) the parameters are
    DTensors on it, ``init_params`` and ``load_state_dict`` take and place
    full tensors, inputs may be full tensors or DTensors, and the outputs
    (logits, caches) are DTensors. ``opt_attn_sharding`` pins the
    attention's head layout and ``opt_seq_parallel`` shards the residual
    stream's sequence over ``model`` (the reference's perf knobs; no-ops
    without a mesh, and neither moves a logit)."""

    def __init__(self, config: ModelConfig, *, device="cuda",
                 remat_policy: str = "full", mesh=None,
                 data_axes: tuple[str, ...] = ("data",),
                 model_axes: tuple[str, ...] = ("model",),
                 opt_attn_sharding: bool = False,
                 opt_seq_parallel: bool = False):
        super().__init__()
        c = config
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {remat_policy!r}")
        self.remat_policy = remat_policy
        self.config = c
        self.device = resolve_device(device)
        self.n_groups = c.n_layers // c.moe_interleave
        self.interleave = c.moe_interleave
        self.n_mlp_slots = (self.interleave - 1) if c.is_moe else (
            self.interleave if c.d_ff > 0 else 0)
        dt = _dtype(c)
        g, i, d, vp = self.n_groups, self.interleave, c.d_model, c.padded_vocab
        h, hkv, hd, ff = c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff

        def param(shape, dtype=dt):   # on a mesh: a shape, placed below
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=(
                "meta" if mesh is not None else self.device)),
                requires_grad=False)

        books = (c.n_codebooks,) if c.n_codebooks > 1 else ()
        self.embed = param(books + (vp, d))
        self.lm_head = param(books + (d, vp))
        self.final_norm = param((d,), torch.float32)
        if c.n_prefix > 0:
            self.prefix_proj = param((d, d))
        if c.n_meta_tokens > 0:
            self.meta_tokens = param((c.n_meta_tokens, d))
        blocks = {"norm1": param((g, i, d), torch.float32)}
        if c.has_attention:
            blocks.update(wq=param((g, i, d, h * hd)),
                          wk=param((g, i, d, hkv * hd)),
                          wv=param((g, i, d, hkv * hd)),
                          wo=param((g, i, h * hd, d)))
        if self.n_mlp_slots > 0:
            m = self.n_mlp_slots
            blocks.update(norm2=param((g, m, d), torch.float32),
                          mlp_gate=param((g, m, d, ff)),
                          mlp_up=param((g, m, d, ff)),
                          mlp_down=param((g, m, ff, d)))
        if c.is_moe:
            e = c.n_experts
            blocks.update(moe_norm=param((g, d), torch.float32),
                          router=param((g, d, e)),
                          moe_gate=param((g, e, d, ff)),
                          moe_up=param((g, e, d, ff)),
                          moe_down=param((g, e, ff, d)))
        self.blocks = nn.ParameterDict(blocks)
        if c.has_ssm:
            dims = ssm_dims(c)
            f32, k = torch.float32, c.ssm_conv
            nh, conv = dims["nheads"], dims["conv_dim"]
            self.blocks.add_module("ssm", nn.ParameterDict(dict(
                in_proj=param((g, i, d, dims["in_dim"])),
                conv_w=param((g, i, k, conv), f32),
                conv_b=param((g, i, conv), f32),
                dt_bias=param((g, i, nh), f32),
                a_log=param((g, i, nh), f32),
                d_skip=param((g, i, nh), f32),
                norm_w=param((g, i, dims["d_inner"]), f32),
                out_proj=param((g, i, dims["d_inner"], d)))))
        self.mesh = mesh
        self.data_axes, self.model_axes = tuple(data_axes), tuple(model_axes)
        self.opt_attn_sharding = opt_attn_sharding
        self.opt_seq_parallel = opt_seq_parallel
        if mesh is not None:
            self._specs = shlib.param_pspecs(c, self.data_axes)
            # the tokens over the data axes; and, where they do not split
            # evenly, replicated over them (capacity from all the tokens,
            # as the reference's unsharded path computes it)
            self._moe_sharded = {
                split: moe_ffn_sharded(mesh, self.data_axes if split else (),
                                       self.model_axes)
                for split in (True, False)} if c.is_moe else None
            for name, p in list(self.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                table = self.get_submodule(owner) if owner else self
                placed = nn.Parameter(self._zeros(p.shape, p.dtype,
                                                  self._specs[name]),
                                      requires_grad=False)
                if isinstance(table, nn.ParameterDict):
                    table[leaf] = placed
                else:
                    setattr(self, leaf, placed)

    # ------------------------------------------------------------------ #
    # the mesh: placing tensors, the reference's sharding constraints
    # ------------------------------------------------------------------ #
    def _block(self, shape, pl) -> tuple:
        """This rank's block of a ``shape`` tensor placed by ``pl``, as
        slices."""
        size, off = compute_local_shape_and_global_offset(
            torch.Size(shape), self.mesh, pl)
        return tuple(slice(o, o + n) for o, n in zip(off, size))

    def _dtensor(self, local: torch.Tensor, shape, pl) -> DTensor:
        shape = torch.Size(shape)
        return DTensor.from_local(
            local, self.mesh, pl, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    def _place(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """A full tensor (the same on every rank, on any device) as a
        DTensor of ``spec`` on the mesh: each rank moves only its own block
        to the module's device; no communication."""
        pl = shlib.placements(self.mesh, spec)
        block = self._block(t.shape, pl)
        return self._dtensor(t[block].to(self.device).contiguous(), t.shape,
                             pl)

    def _zeros(self, shape, dtype, spec: tuple) -> DTensor:
        """Zeros of ``shape`` placed by ``spec``, each rank allocating its
        own block only."""
        pl = shlib.placements(self.mesh, spec)
        block = self._block(shape, pl)
        return self._dtensor(torch.zeros([b.stop - b.start for b in block],
                                         dtype=dtype, device=self.device),
                             shape, pl)

    def _dp(self):
        return self.data_axes if len(self.data_axes) > 1 \
            else self.data_axes[0]

    def _batch_spec(self, batch: int):
        """The data axes where ``batch`` divides over them, else None."""
        return self._dp() if shlib._divisible(batch, self.data_axes,
                                              self.mesh) else None

    def shard_input(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """A full (B, ...) input as a DTensor with its batch over the data
        axes (replicated where B does not divide); DTensors and, without
        a mesh, every tensor pass as they are."""
        if self.mesh is None or t is None or isinstance(t, DTensor):
            return t
        spec = (self._batch_spec(t.shape[0]),) + (None,) * (t.dim() - 1)
        return self._place(t, spec)

    def mesh_context(self):
        """On a mesh, plain tensors meeting DTensors count as replicated
        (positions, masks and scalars made inside the step). The forward
        and decode enter it themselves; a backward through a mesh model
        runs under it too (``torch.autograd.grad`` inside ``with
        model.mesh_context():``)."""
        return _replicate_plain() if self.mesh is not None \
            else contextlib.nullcontext()

    def _constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """The reference's attention sharding constraint: a redistribute
        to ``spec`` under ``opt_attn_sharding`` on a mesh, else x. The
        batch entry drops to None where the batch does not divide (GSPMD
        pads it)."""
        if self.mesh is None or not self.opt_attn_sharding:
            return x
        spec = (self._batch_spec(x.shape[0]),) + spec[1:]
        return x.redistribute(self.mesh, shlib.placements(self.mesh, spec))

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream's layout on a mesh, and each sublayer's
        exit into it: batch over data, replicated over ``model`` (a
        tensor-parallel sublayer exits through an all-reduce); under
        ``opt_seq_parallel`` (Megatron-SP, the reference's ``_sp``) the
        sequence over ``model`` where it divides, so the exit is a
        reduce-scatter and norms and adds run on 1/TP of the tokens.
        Pinned at every exit, where the reference leaves the stream to
        GSPMD: DTensor's op-by-op choice shards the tokens of a flattened
        (B*L) operand over ``model`` in an order whose redistributions it
        plans by an exhaustive search (minutes on the 3-axis mesh)."""
        if self.mesh is None:
            return x
        seq = None
        if self.opt_seq_parallel and x.dim() == 3 and x.shape[1] % \
                mesh_axis_size(self.mesh, self.model_axes) == 0:
            seq = self.model_axes if len(self.model_axes) > 1 \
                else self.model_axes[0]
        spec = (self._batch_spec(x.shape[0]), seq) + (None,) * (x.dim() - 2)
        return self._to_spec(x, spec)

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """A sublayer's input with its whole sequence (Megatron-SP's
        all-gather before the column-parallel projections); a no-op
        unless ``opt_seq_parallel`` sharded it."""
        if self.mesh is None or not self.opt_seq_parallel:
            return x
        spec = (self._batch_spec(x.shape[0]),) + (None,) * (x.dim() - 1)
        return self._to_spec(x, spec)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """``nn.Module.load_state_dict``; on a mesh each full tensor (on
        any device, the host's for one) is placed by its spec first, each
        rank moving only its block to the module's device."""
        if self.mesh is not None:
            state_dict = {
                n: t if isinstance(t, DTensor) or n not in self._specs
                else self._place(t, self._specs[n])
                for n, t in state_dict.items()}
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    # ------------------------------------------------------------------ #
    # parameter construction
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Random init with the JAX package's scales: normal x scale drawn
        in f32 on the module's device from ``generator`` (which must live
        there), cast to the parameter's dtype; norms, ``d_skip`` ones, the
        SSM biases and ``a_log`` zeros. A stacked weight is drawn one
        matrix at a time (a layer slot's, an expert's), so no f32
        temporary is larger than one matrix: grok-1's (8, 6144, 32768)
        experts of a layer would take 6.4 GB at once. The numbers differ
        from JAX's ``init_params``; tests carry JAX's across. On a mesh
        each rank draws the same matrices in the same order, keeps its
        block of each and frees the rest, so the numbers are the unsharded
        init's and no rank holds more than one full matrix beside its
        shards."""
        c = self.config
        d, hd = c.d_model, c.head_dim

        def draw(shape, scale):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=self.device) \
                * scale

        def nrm(p, scale):
            if not isinstance(p, DTensor):
                for m in p.view(-1, *p.shape[-2:]):   # one matrix at a time
                    m.copy_(draw(m.shape, scale))
                return
            block = self._block(p.shape, p.placements)
            local = p.to_local()
            for idx in itertools.product(*map(range, p.shape[:-2])):
                m = draw(p.shape[-2:], scale)
                if all(b.start <= i < b.stop for i, b in zip(idx, block)):
                    local[tuple(i - b.start for i, b in zip(idx, block))] \
                        .copy_(m[block[-2:]])

        nrm(self.embed, 0.02)
        nrm(self.lm_head, d ** -0.5)
        self.final_norm.fill_(1.0)
        if c.n_prefix > 0:
            nrm(self.prefix_proj, d ** -0.5)
        if c.n_meta_tokens > 0:
            nrm(self.meta_tokens, 0.02)
        b = self.blocks
        b["norm1"].fill_(1.0)
        if c.has_attention:
            nrm(b["wq"], d ** -0.5)
            nrm(b["wk"], d ** -0.5)
            nrm(b["wv"], d ** -0.5)
            nrm(b["wo"], (c.n_heads * hd) ** -0.5)
        if self.n_mlp_slots > 0:
            b["norm2"].fill_(1.0)
            nrm(b["mlp_gate"], d ** -0.5)
            nrm(b["mlp_up"], d ** -0.5)
            nrm(b["mlp_down"], c.d_ff ** -0.5)
        if c.is_moe:
            b["moe_norm"].fill_(1.0)
            nrm(b["router"], d ** -0.5)
            nrm(b["moe_gate"], d ** -0.5)
            nrm(b["moe_up"], d ** -0.5)
            nrm(b["moe_down"], c.d_ff ** -0.5)
        if c.has_ssm:
            sp = b.ssm
            nrm(sp["in_proj"], d ** -0.5)
            nrm(sp["conv_w"], c.ssm_conv ** -0.5)
            nrm(sp["out_proj"], c.d_inner ** -0.5)
            for name in ("conv_b", "dt_bias", "a_log"):
                sp[name].zero_()
            sp["d_skip"].fill_(1.0)
            sp["norm_w"].fill_(1.0)
        return self

    # ------------------------------------------------------------------ #
    # per-layer pieces
    # ------------------------------------------------------------------ #
    def _qkv(self, g: int, s: int, xn: torch.Tensor,
             positions: torch.Tensor):
        c = self.config
        b, l, _ = xn.shape
        h, hkv, hd = c.n_heads, c.n_kv_heads, c.head_dim
        lp = self.blocks
        q = self._whole_heads(xn @ lp["wq"][g, s], h).reshape(b, l, h, hd)
        k = self._whole_heads(xn @ lp["wk"][g, s], hkv).reshape(b, l, hkv, hd)
        v = self._whole_heads(xn @ lp["wv"][g, s], hkv).reshape(b, l, hkv, hd)
        return rope_for(c, q, positions), rope_for(c, k, positions), v

    @staticmethod
    def _whole_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
        """A projection whose fused ``heads * hd`` dim is sharded where
        its shards would end mid-head (hymba's 25 heads, qwen2-vl's 2 KV
        heads over 16 ranks): gathered over those mesh dims first, since
        DTensor cannot split the dim into (heads, hd) there. GSPMD pads
        instead (ROADMAP, kept on purpose)."""
        if not isinstance(t, DTensor):
            return t
        last = Shard(t.dim() - 1)
        dims = [i for i, p in enumerate(t.placements) if p == last]
        if n_heads % math.prod(t.device_mesh.size(i) for i in dims) == 0:
            return t
        return t.redistribute(t.device_mesh, [
            Replicate() if p == last else p for p in t.placements])

    def _ssm_params(self, g: int, s: int) -> dict:
        return {name: self.blocks.ssm[name][g, s] for name in SSM_LEAVES}

    def _ssm_seq(self, g: int, s: int, xn: torch.Tensor, collect: bool):
        """``ssm_forward`` of slot ``s``; on a mesh under ``local_map``:
        the SSM parameters are replicated and the tokens keep their batch
        split, so each rank scans its own sequences (DTensor has no rule
        for the scan's padding on torch 2.11); the parameters' gradients
        are partial over the axes the batch splits over."""
        params = self._ssm_params(g, s)
        if self.mesh is None:
            return ssm_forward(params, xn, self.config, return_state=collect)
        from torch.distributed.tensor import Partial
        from torch.distributed.tensor.experimental import local_map
        x_p = tuple(xn.placements)
        rep = (Replicate(),) * len(x_p)
        grad = tuple(Partial() if p != Replicate() else p for p in x_p)

        def fn(xl, *leaves):
            return ssm_forward(dict(zip(SSM_LEAVES, leaves)), xl,
                               self.config, return_state=collect)

        out_p = (list(x_p),) * 3 if collect else list(x_p)
        return local_map(fn, out_placements=out_p,
                         in_placements=(x_p,) + (rep,) * len(SSM_LEAVES),
                         in_grad_placements=(x_p,) + (grad,) * len(
                             SSM_LEAVES), device_mesh=self.mesh,
                         redistribute_inputs=True)(
            xn, *(params[n] for n in SSM_LEAVES))

    def _ffn(self, g: int, s: int, x: torch.Tensor):
        """The FFN sublayer of slot ``s``: (y, aux) for the MoE block in a
        MoE group's last slot (aux its load-balance loss, f32), (y, None)
        for a SwiGLU MLP in the first ``n_mlp_slots``, else None."""
        c, lp = self.config, self.blocks
        if c.is_moe and s == self.interleave - 1:
            xn = self._gathered(rms_norm(x, lp["moe_norm"][g]))
            b, l, d = xn.shape
            fn = moe_ffn
            if self.mesh is not None:
                # the reference's rule: the shard_map form where the tokens
                # split evenly over the data axes
                fn = self._moe_sharded[shlib._divisible(
                    b * l, self.data_axes, self.mesh)]
            y, aux = fn(xn.reshape(b * l, d), lp["router"][g],
                        lp["moe_gate"][g], lp["moe_up"][g],
                        lp["moe_down"][g], topk=c.moe_topk,
                        capacity_factor=c.capacity_factor)
            return y.reshape(b, l, d), aux
        if s < self.n_mlp_slots:
            xn = self._gathered(rms_norm(x, lp["norm2"][g, s]))
            return self._residual(swiglu(xn, lp["mlp_gate"][g, s],
                                         lp["mlp_up"][g, s],
                                         lp["mlp_down"][g, s])), None
        return None

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings; audio sums its codebooks' tables over (B, L,
        C) tokens, in codebook order."""
        c = self.config
        look = (lambda table, t: table[t]) if self.mesh is None \
            else self._embed_on_mesh
        if c.n_codebooks == 1:
            return look(self.embed, tokens)
        if tokens.dim() != 3 or tokens.shape[-1] != c.n_codebooks:
            raise ValueError(
                f"{c.name} takes (B, L, {c.n_codebooks}) codebook tokens, got "
                f"shape {tuple(tokens.shape)}")
        x = look(self.embed[0], tokens[..., 0])
        for cb in range(1, c.n_codebooks):
            x = x + look(self.embed[cb], tokens[..., cb])
        return x

    def _embed_on_mesh(self, table, tokens):
        """The vocab-parallel lookup (``parallel.vocab_embedding``): the
        vocab-sharded table stays in place, where indexing would gather
        it. DTensor's own rule for ``F.embedding`` (a masked partial
        result) has no backward into the table here."""
        return vocab_embedding(table, tokens, self.model_axes)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = rms_norm(x, self.final_norm)
        if c.n_codebooks > 1:   # one product a codebook: on a mesh,
            # DTensor (torch 2.11) cannot flatten an einsum's vocab-sharded
            # operand on 3 mesh axes
            logits = torch.stack([x @ self.lm_head[cb] for cb in
                                  range(c.n_codebooks)], dim=2)
            return unembed_multi(logits, c.vocab)
        return unembed(x, self.lm_head, c.vocab)

    def _layers(self):
        """(group, slot, layer index, attention window or None = global)
        in order: hybrid configs with ``global_attn_every`` are global on
        every such layer and ``sliding_window`` elsewhere; others use
        ``sliding_window`` everywhere, or are global."""
        for g in range(self.n_groups):
            for s in range(self.interleave):
                li = g * self.interleave + s
                yield g, s, li, self._window(li)

    def _window(self, li: int) -> int | None:
        return layer_window(self.config, li)

    def _prepend_context(self, x: torch.Tensor, positions: torch.Tensor,
                         prefix_emb: torch.Tensor | None = None):
        """Prepend the meta tokens (hymba), then the frontend embeddings
        (B, P, d) projected by ``prefix_proj`` (audio, vlm): returns (x,
        positions, n_lead), the prepended tokens at positions
        0..n_lead-1 (M-RoPE: the stub grid's (0, row, col)) and the text's
        shifted up by n_lead; M-RoPE positions as (B, L, 3) triples."""
        c = self.config
        b = x.shape[0]
        lead = []
        if c.n_meta_tokens > 0:
            lead.append(self.meta_tokens[None].expand(b, -1, -1).to(x.dtype))
        if prefix_emb is not None:
            if c.n_prefix == 0:
                raise ValueError(f"{c.name} takes no prefix embeddings "
                                 "(its config has n_prefix = 0)")
            lead.append(prefix_emb.to(x.dtype) @ self.prefix_proj)
        if not lead:
            return x, positionize(c, positions), 0
        lead_x = torch.cat(lead, dim=1)
        n_lead = lead_x.shape[1]
        x = torch.cat([lead_x, x], dim=1)
        if c.mrope:
            lead_pos = self._mrope_grid_positions(b, n_lead, positions.device)
            return x, torch.cat([lead_pos, positionize(c, positions) + n_lead],
                                dim=1), n_lead
        lead_pos = torch.arange(n_lead, dtype=positions.dtype,
                                device=positions.device).expand(b, n_lead)
        return x, torch.cat([lead_pos, positions + n_lead], dim=1), n_lead

    @staticmethod
    def _mrope_grid_positions(b: int, n: int, device) -> torch.Tensor:
        """Stub-ViT patch grid M-RoPE positions (t=0, h=row, w=col) on a
        square of side ``max(int(sqrt(n)), 1)``: (b, n, 3) int32."""
        side = max(int(n ** 0.5), 1)
        idx = torch.arange(n, dtype=torch.int32, device=device)
        pos3 = torch.stack([torch.zeros_like(idx), idx // side, idx % side],
                           dim=-1)
        return pos3[None].expand(b, n, 3)

    # ------------------------------------------------------------------ #
    # full-sequence forward (prefill)
    # ------------------------------------------------------------------ #
    def forward(self, tokens: torch.Tensor, *,
                prefix_emb: torch.Tensor | None = None,
                collect_cache: bool = False, cache_size: int | None = None,
                logits_last_only: bool = False, remat: bool = False,
                return_aux: bool = False):
        """tokens (B, L), or (B, L, C) for audio -> logits (B, L, Vp) or
        (B, L, C, Vp), or the last position's only with
        ``logits_last_only``; ``prefix_emb`` (B, P, d) frontend embeddings
        (audio, vlm) are projected and prepended, and the logits cover the
        text positions. With ``collect_cache`` also the prefill's
        ``DecodeCaches``: KV caches sized ``cache_size`` (default the
        prefill's length, prepended tokens included), a padded copy in the
        front of the cache or a ring holding the last ``cache_size``
        positions; SSM states after the last position. With
        ``return_aux`` the summed MoE auxiliary loss (f32, 0 without MoE)
        comes last, as JAX returns it. ``remat`` rematerializes each layer
        group in the backward by the model's ``remat_policy``."""
        with self.mesh_context():
            return self._forward(self.shard_input(tokens),
                                 self.shard_input(prefix_emb), collect_cache,
                                 cache_size, logits_last_only, remat,
                                 return_aux)

    def _forward(self, tokens, prefix_emb, collect_cache, cache_size,
                 logits_last_only, remat, return_aux):
        b, l_text = tokens.shape[:2]
        x = self._embed(tokens)
        positions = torch.arange(l_text, dtype=torch.int32,
                                 device=tokens.device).expand(b, l_text)
        x, positions, n_lead = self._prepend_context(x, positions, prefix_emb)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        policy = self.remat_policy if remat and torch.is_grad_enabled() \
            else "none"
        ys = []
        for g in range(self.n_groups):
            if policy == "none":
                x, aux, y = self._group(g, x, aux, positions, collect_cache)
            else:
                context = functools.partial(
                    ckpt.create_selective_checkpoint_contexts, _dots_policy) \
                    if policy == "dots" else ckpt.noop_context_fn
                x, aux, y = ckpt.checkpoint(
                    self._group, g, x, aux, positions, collect_cache,
                    use_reentrant=False, context_fn=context)
            ys.extend(y)
        logits = self._head(x[:, -1:] if logits_last_only else x[:, n_lead:])
        out = (logits,)
        if collect_cache:
            l_total = x.shape[1]
            kv = self._prefill_kv([y[0] for y in ys], [y[1] for y in ys],
                                  l_total, cache_size) \
                if self.config.has_attention else None
            ssm = SSMState(conv=torch.stack([y[2] for y in ys]),
                           ssd=torch.stack([y[3] for y in ys])) \
                if self.config.has_ssm else None
            if ssm is not None and self.mesh is not None:
                spec = shlib.decode_cache_pspecs(
                    self.config, b, self.data_axes, mesh=self.mesh).ssm
                ssm = SSMState(conv=self._to_spec(ssm.conv, spec.conv),
                               ssd=self._to_spec(ssm.ssd, spec.ssd))
            out += (DecodeCaches(kv=kv, ssm=ssm),)
        if return_aux:
            out += (aux,)
        return out[0] if len(out) == 1 else out

    def _group(self, g: int, x: torch.Tensor, aux: torch.Tensor,
               positions: torch.Tensor, collect_cache: bool):
        """The layers of group ``g`` (JAX's scanned ``group_body``):
        returns (x, aux, per layer (k, v, conv, ssd) when collecting the
        caches, each None where the family has no such state)."""
        c = self.config
        b, l = x.shape[:2]
        ys = []
        for s in range(self.interleave):
            win = self._window(g * self.interleave + s)
            xn = self._gathered(rms_norm(x, self.blocks["norm1"][g, s]))
            k = v = conv = ssd = None
            if c.has_ssm:
                out = self._ssm_seq(g, s, xn, collect_cache)
                if collect_cache:
                    out, conv, ssd = out
                out = self._residual(out)
            if c.has_attention:
                q, k, v = self._qkv(g, s, xn, positions)
                attn = self._attn_seq(g, s, q, k, v, win)
            if c.arch_type == "hybrid":   # per-branch norm, then the mean
                fused = 0.5 * (_branch_norm(attn) + _branch_norm(out))
                x = self._residual(x + fused.to(x.dtype))
            else:
                x = self._residual(x + (attn if c.has_attention else out))
            ffn = self._ffn(g, s, x)
            if ffn is not None:
                x = self._residual(x + ffn[0])
                if ffn[1] is not None:
                    aux = aux + ffn[1]
            if collect_cache:
                ys.append((k, v, conv, ssd))
        return x, aux, ys

    def _attn_seq(self, g: int, s: int, q, k, v, win) -> torch.Tensor:
        """Prefill attention and its output projection; under
        ``opt_attn_sharding`` the reference's layout: query heads over
        ``model``, KV expanded to the query heads where there are fewer
        (so the head split holds through the attention), the output
        batch-sharded and replicated over ``model``."""
        c = self.config
        b, l, h = q.shape[:3]
        if self.opt_attn_sharding and self.mesh is not None \
                and k.shape[2] < h:
            k = k.repeat_interleave(h // k.shape[2], dim=2)
            v = v.repeat_interleave(h // v.shape[2], dim=2)
        q = self._constrain(q, None, None, "model", None)
        k = self._constrain(k, None, None,
                            "model" if k.shape[2] == h else None, None)
        v = self._constrain(v, None, None,
                            "model" if v.shape[2] == h else None, None)
        o = blockwise_attention(q, k, v, causal=True, window=win,
                                n_sink=c.n_meta_tokens)
        o = self._constrain(o, None, None, "model", None).reshape(b, l, -1)
        if isinstance(o, DTensor):
            # an identity redistribute: its backward brings the gradient
            # to o's own layout (whole heads) before the reshape's backward
            # splits the fused dim into heads, which DTensor cannot do
            # where a shard of it would end mid-head (llama4's 40 heads)
            o = o.redistribute(o.device_mesh, o.placements)
        out = o @ self.blocks["wo"][g, s]
        return self._residual(out)

    def loss_fn(self, tokens: torch.Tensor, *,
                prefix_emb: torch.Tensor | None = None, remat: bool = True,
                aux_weight: float = 0.01) -> torch.Tensor:
        """Next-token cross-entropy over the text positions (averaged over
        every codebook for audio) plus ``aux_weight`` times the summed MoE
        auxiliary loss: ``repro.models.model.Model.loss_fn``."""
        tokens = self.shard_input(tokens)
        logits, aux = self.forward(tokens, prefix_emb=prefix_emb,
                                   remat=remat, return_aux=True)
        with self.mesh_context():
            logp = torch.log_softmax(logits.to(torch.float32)[:, :-1],
                                     dim=-1)
            nll = -torch.gather(logp, -1, tokens[:, 1:, ..., None].long())
            return nll.mean() + aux_weight * aux

    def _prefill_kv(self, ks: list, vs: list, l_total: int,
                    cache_size: int | None) -> KVCache:
        k, v = torch.stack(ks), torch.stack(vs)   # (L, B, l_total, HKV, D)
        dev = k.device
        size = cache_size or l_total
        if size >= l_total:                # plain copy into the front
            pad = size - l_total
            shape = (k.shape[0], k.shape[1], pad) + k.shape[3:]
            k = torch.cat([k, k.new_zeros(shape)], dim=2)
            v = torch.cat([v, v.new_zeros(shape)], dim=2)
            slot_pos = torch.cat([
                torch.arange(l_total, dtype=torch.int32, device=dev),
                torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        else:                              # ring: keep the last `size`
            slots = torch.arange(size, device=dev)
            last = l_total - 1
            pos_i = last - ((last - slots) % size)
            take = torch.where(pos_i >= 0, pos_i, 0)
            k = k.index_select(2, take)
            v = v.index_select(2, take)
            slot_pos = torch.where(pos_i >= 0, pos_i, -1).to(torch.int32)
        kv = KVCache(k=k.contiguous(), v=v.contiguous(), slot_pos=slot_pos,
                     pos=l_total)
        if self.mesh is not None:   # the decode caches' layout
            spec = shlib.decode_cache_pspecs(self.config, k.shape[1],
                                             self.data_axes, mesh=self.mesh)
            kv.k = self._to_spec(kv.k, spec.kv.k)
            kv.v = self._to_spec(kv.v, spec.kv.v)
        return kv

    def _to_spec(self, t, spec):
        return t.redistribute(self.mesh, shlib.placements(self.mesh, spec))

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def init_decode_caches(self, batch: int, cache_size: int,
                           kv_quantized: bool = False) -> DecodeCaches:
        """Empty caches; on a mesh placed by ``decode_cache_pspecs``."""
        c = self.config
        # on a mesh the shapes only, then each rank's blocks of zeros
        dev = self.device if self.mesh is None else "meta"
        kv = init_kv_cache(
            c.n_layers, batch, cache_size, c.n_kv_heads, c.head_dim,
            dtype=_dtype(c), quantized=kv_quantized, device=dev) \
            if c.has_attention else None
        ssm = init_ssm_state(c, batch, dev) if c.has_ssm else None
        if self.mesh is not None:
            spec = shlib.decode_cache_pspecs(c, batch, self.data_axes,
                                             kv_quantized, mesh=self.mesh)
            if kv is not None:
                kv.slot_pos = torch.full_like(kv.slot_pos, -1,
                                              device=self.device)
            for state, specs in ((kv, spec.kv), (ssm, spec.ssm)):
                for f in ("k", "v", "k_scale", "v_scale", "conv", "ssd"):
                    t = getattr(state, f, None)
                    if t is not None:
                        setattr(state, f, self._zeros(t.shape, t.dtype,
                                                      getattr(specs, f)))
        return DecodeCaches(kv=kv, ssm=ssm)

    def decode_step(self, caches: DecodeCaches, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, DecodeCaches]:
        """One token for every sequence: tokens (B, 1), or (B, 1, C) for
        audio -> logits (B, 1, Vp) or (B, 1, C, Vp) and the caches one
        position on. Inference only: it raises while grad mode is on and a
        parameter requires grad (the caches are written in place, and the
        decode kernel has no backward).

        The caches' K/V and SSM tensors are updated in place and returned
        in the new ``DecodeCaches``. As in JAX, every layer's
        ``cache_write`` gets the step's un-updated ``slot_pos``, and the
        new one is written once at the end. A global layer passes
        ``window=None`` where JAX passes its traced ``2**30``; both give
        the same visibility. Without a KV cache (ssm) the step has no
        position, as JAX's ``_ssm_pos`` gives 0: nothing reads it."""
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in self.parameters()):
            raise RuntimeError("decode_step is inference only: call it under "
                               "torch.no_grad() or torch.inference_mode()")
        with self.mesh_context():
            return self._decode_step(caches, self.shard_input(tokens))

    def _decode_step(self, caches: DecodeCaches, tokens: torch.Tensor):
        c = self.config
        b = tokens.shape[0]
        kv, st = caches.kv, caches.ssm
        pos = kv.pos if kv is not None else 0
        quant = kv is not None and kv.quantized
        x = self._embed(tokens)
        positions = positionize(c, torch.full((b, 1), pos, dtype=torch.int32,
                                              device=tokens.device))
        slot_pos = kv.slot_pos if kv is not None else None
        for g, s, li, win in self._layers():
            xn = self._gathered(rms_norm(x, self.blocks["norm1"][g, s]))
            if c.has_ssm:
                out, conv, ssd = ssm_decode_step(
                    self._ssm_params(g, s), xn, st.conv[li], st.ssd[li], c)
                out = self._residual(out)
                st.conv[li].copy_(conv)
                st.ssd[li].copy_(ssd)
            if c.has_attention:
                q, k1, v1 = self._qkv(g, s, xn, positions)
                kc, vc, sp, ksc, vsc = cache_write(
                    kv.k[li], kv.v[li], slot_pos, k1, v1, pos,
                    kv.k_scale[li] if quant else None,
                    kv.v_scale[li] if quant else None)
                o = decode_attention(q, kc, vc, sp, pos, window=win,
                                     n_sink=c.n_meta_tokens, k_scale=ksc,
                                     v_scale=vsc)
                attn = self._residual(o.reshape(b, 1, -1)
                                      @ self.blocks["wo"][g, s])
            if c.arch_type == "hybrid":
                fused = 0.5 * (_branch_norm(attn) + _branch_norm(out))
                x = self._residual(x + fused.to(x.dtype))
            else:
                x = self._residual(x + (attn if c.has_attention else out))
            ffn = self._ffn(g, s, x)
            if ffn is not None:
                x = self._residual(x + ffn[0])
        logits = self._head(x)
        new_kv = None
        if kv is not None:
            new_slot = slot_pos.clone()
            new_slot[pos % kv.size] = pos
            new_kv = KVCache(k=kv.k, v=kv.v, slot_pos=new_slot, pos=pos + 1,
                             k_scale=kv.k_scale, v_scale=kv.v_scale)
        return logits, DecodeCaches(kv=new_kv, ssm=st)
