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
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models.attention import (KVCache, blockwise_attention,
                                          cache_write, decode_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (_branch_norm, positionize, rms_norm,
                                       rope_for, swiglu, unembed)
from repro_torch.models.moe import moe_ffn
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
    never numbers."""

    def __init__(self, config: ModelConfig, *, device="cuda",
                 remat_policy: str = "full"):
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

        def param(shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=self.device),
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
        from JAX's ``init_params``; tests carry JAX's across."""
        c = self.config
        d, hd = c.d_model, c.head_dim

        def nrm(p, scale):
            for m in p.view(-1, *p.shape[-2:]):   # one matrix at a time
                m.copy_(torch.randn(m.shape, generator=generator,
                                    dtype=torch.float32,
                                    device=self.device) * scale)

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
        q = (xn @ lp["wq"][g, s]).reshape(b, l, h, hd)
        k = (xn @ lp["wk"][g, s]).reshape(b, l, hkv, hd)
        v = (xn @ lp["wv"][g, s]).reshape(b, l, hkv, hd)
        return rope_for(c, q, positions), rope_for(c, k, positions), v

    def _ssm_params(self, g: int, s: int) -> dict:
        return {name: self.blocks.ssm[name][g, s] for name in SSM_LEAVES}

    def _ffn(self, g: int, s: int, x: torch.Tensor):
        """The FFN sublayer of slot ``s``: (y, aux) for the MoE block in a
        MoE group's last slot (aux its load-balance loss, f32), (y, None)
        for a SwiGLU MLP in the first ``n_mlp_slots``, else None."""
        c, lp = self.config, self.blocks
        if c.is_moe and s == self.interleave - 1:
            xn = rms_norm(x, lp["moe_norm"][g])
            b, l, d = xn.shape
            y, aux = moe_ffn(xn.reshape(b * l, d), lp["router"][g],
                             lp["moe_gate"][g], lp["moe_up"][g],
                             lp["moe_down"][g], topk=c.moe_topk,
                             capacity_factor=c.capacity_factor)
            return y.reshape(b, l, d), aux
        if s < self.n_mlp_slots:
            xn = rms_norm(x, lp["norm2"][g, s])
            return swiglu(xn, lp["mlp_gate"][g, s], lp["mlp_up"][g, s],
                          lp["mlp_down"][g, s]), None
        return None

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings; audio sums its codebooks' tables over (B, L,
        C) tokens, in codebook order."""
        c = self.config
        if c.n_codebooks == 1:
            return self.embed[tokens]
        if tokens.dim() != 3 or tokens.shape[-1] != c.n_codebooks:
            raise ValueError(
                f"{c.name} takes (B, L, {c.n_codebooks}) codebook tokens, got "
                f"shape {tuple(tokens.shape)}")
        x = self.embed[0][tokens[..., 0]]
        for cb in range(1, c.n_codebooks):
            x = x + self.embed[cb][tokens[..., cb]]
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = rms_norm(x, self.final_norm)
        if c.n_codebooks > 1:
            return unembed_multi(torch.einsum("bld,cdv->blcv", x,
                                              self.lm_head), c.vocab)
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
            xn = rms_norm(x, self.blocks["norm1"][g, s])
            k = v = conv = ssd = None
            if c.has_ssm:
                out = ssm_forward(self._ssm_params(g, s), xn, c,
                                  return_state=collect_cache)
                if collect_cache:
                    out, conv, ssd = out
            if c.has_attention:
                q, k, v = self._qkv(g, s, xn, positions)
                o = blockwise_attention(q, k, v, causal=True, window=win,
                                        n_sink=c.n_meta_tokens)
                attn = o.reshape(b, l, -1) @ self.blocks["wo"][g, s]
            if c.arch_type == "hybrid":   # per-branch norm, then the mean
                fused = 0.5 * (_branch_norm(attn) + _branch_norm(out))
                x = x + fused.to(x.dtype)
            else:
                x = x + (attn if c.has_attention else out)
            ffn = self._ffn(g, s, x)
            if ffn is not None:
                x = x + ffn[0]
                if ffn[1] is not None:
                    aux = aux + ffn[1]
            if collect_cache:
                ys.append((k, v, conv, ssd))
        return x, aux, ys

    def loss_fn(self, tokens: torch.Tensor, *,
                prefix_emb: torch.Tensor | None = None, remat: bool = True,
                aux_weight: float = 0.01) -> torch.Tensor:
        """Next-token cross-entropy over the text positions (averaged over
        every codebook for audio) plus ``aux_weight`` times the summed MoE
        auxiliary loss: ``repro.models.model.Model.loss_fn``."""
        logits, aux = self.forward(tokens, prefix_emb=prefix_emb,
                                   remat=remat, return_aux=True)
        logp = torch.log_softmax(logits.to(torch.float32)[:, :-1], dim=-1)
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
        return KVCache(k=k.contiguous(), v=v.contiguous(), slot_pos=slot_pos,
                       pos=l_total)

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def init_decode_caches(self, batch: int, cache_size: int,
                           kv_quantized: bool = False) -> DecodeCaches:
        c = self.config
        kv = init_kv_cache(
            c.n_layers, batch, cache_size, c.n_kv_heads, c.head_dim,
            dtype=_dtype(c), quantized=kv_quantized, device=self.device) \
            if c.has_attention else None
        ssm = init_ssm_state(c, batch, self.device) if c.has_ssm else None
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
        c = self.config
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in self.parameters()):
            raise RuntimeError("decode_step is inference only: call it under "
                               "torch.no_grad() or torch.inference_mode()")
        b = tokens.shape[0]
        kv, st = caches.kv, caches.ssm
        pos = kv.pos if kv is not None else 0
        quant = kv is not None and kv.quantized
        x = self._embed(tokens)
        positions = positionize(c, torch.full((b, 1), pos, dtype=torch.int32,
                                              device=tokens.device))
        slot_pos = kv.slot_pos if kv is not None else None
        for g, s, li, win in self._layers():
            xn = rms_norm(x, self.blocks["norm1"][g, s])
            if c.has_ssm:
                out, conv, ssd = ssm_decode_step(
                    self._ssm_params(g, s), xn, st.conv[li], st.ssd[li], c)
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
                attn = o.reshape(b, 1, -1) @ self.blocks["wo"][g, s]
            if c.arch_type == "hybrid":
                fused = 0.5 * (_branch_norm(attn) + _branch_norm(out))
                x = x + fused.to(x.dtype)
            else:
                x = x + (attn if c.has_attention else out)
            ffn = self._ffn(g, s, x)
            if ffn is not None:
                x = x + ffn[0]
        logits = self._head(x)
        new_kv = None
        if kv is not None:
            new_slot = slot_pos.clone()
            new_slot[pos % kv.size] = pos
            new_kv = KVCache(k=kv.k, v=kv.v, slot_pos=new_slot, pos=pos + 1,
                             k_scale=kv.k_scale, v_scale=kv.v_scale)
        return logits, DecodeCaches(kv=new_kv, ssm=st)
