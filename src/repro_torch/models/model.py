"""The decoder behind the model-backed miss path (PyTorch port of
``repro.models.model``): the dense, moe, ssm and hybrid families.

``Model`` is an ``nn.Module`` whose parameters keep the JAX parameter
tree's names and its stacked per-layer layout: ``embed`` (Vp, d),
``lm_head`` (d, Vp), ``final_norm`` (d,) f32, hymba's ``meta_tokens``
(n_meta, d) and ``blocks.<name>`` with a leading (layer group, slot) pair
of axes, e.g. ``blocks.wq`` (n_groups, interleave, d, H*hd); the MoE
leaves are per group (``blocks.router`` (n_groups, d, E)) and the SSM
leaves nest as ``blocks.ssm.<name>``. So ``convert.params_from_jax`` is a
renaming, and one ``load_state_dict`` carries the JAX package's weights
across.

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
    window elsewhere.

Two entry points, as in JAX:
  ``forward``      — full-sequence logits, optionally with the prefill's
                     caches (attention through the flash-attention kernel
                     on CUDA, sinks included);
  ``decode_step``  — one token against the caches (attention through the
                     decode-attention kernel on CUDA).
The projections, norms, RoPE, MLP, MoE dispatch and expert GEMMs and the
SSD scan are plain PyTorch, as the JAX package leaves them to XLA, with
its rounding points: f32 norms cast back, bf16 residual adds. audio and
vlm configs raise ``NotImplementedError`` naming the slice of the port
that brings them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import resolve_device
from repro_torch.models.attention import (KVCache, blockwise_attention,
                                          cache_write, decode_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (_branch_norm, rms_norm, rope_for,
                                       swiglu, unembed)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import (SSMState, init_ssm_state, ssm_decode_step,
                                    ssm_dims, ssm_forward)

_LATER = {"audio": "the audio slice", "vlm": "the vlm slice"}
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


class Model(nn.Module):
    """Config-driven decoder of the dense, moe, ssm and hybrid families.
    Its parameters are allocated, not drawn: call ``init_params`` (random
    init) or ``load_state_dict`` (e.g. of ``convert.params_from_jax``)
    before use. ``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` for the plain path."""

    def __init__(self, config: ModelConfig, *, device="cuda"):
        super().__init__()
        c = config
        if c.arch_type in _LATER:
            raise NotImplementedError(
                f"{c.name}: the {c.arch_type} family arrives with "
                f"{_LATER[c.arch_type]} of the port; the dense, moe, ssm "
                "and hybrid families run")
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

        self.embed = param((vp, d))
        self.lm_head = param((d, vp))
        self.final_norm = param((d,), torch.float32)
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

    def _ffn(self, g: int, s: int, x: torch.Tensor) -> torch.Tensor | None:
        """The FFN sublayer of slot ``s``: the MoE block in a MoE group's
        last slot, a SwiGLU MLP in the first ``n_mlp_slots``, else None.
        The MoE block's auxiliary loss is dropped: nothing here trains."""
        c, lp = self.config, self.blocks
        if c.is_moe and s == self.interleave - 1:
            xn = rms_norm(x, lp["moe_norm"][g])
            b, l, d = xn.shape
            y, _ = moe_ffn(xn.reshape(b * l, d), lp["router"][g],
                           lp["moe_gate"][g], lp["moe_up"][g],
                           lp["moe_down"][g], topk=c.moe_topk,
                           capacity_factor=c.capacity_factor)
            return y.reshape(b, l, d)
        if s < self.n_mlp_slots:
            xn = rms_norm(x, lp["norm2"][g, s])
            return swiglu(xn, lp["mlp_gate"][g, s], lp["mlp_up"][g, s],
                          lp["mlp_down"][g, s])
        return None

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm)
        return unembed(x, self.lm_head, self.config.vocab)

    def _layers(self):
        """(group, slot, layer index, attention window or None = global)
        in order: hybrid configs with ``global_attn_every`` are global on
        every such layer and ``sliding_window`` elsewhere; others use
        ``sliding_window`` everywhere, or are global."""
        c = self.config
        for g in range(self.n_groups):
            for s in range(self.interleave):
                li = g * self.interleave + s
                if c.arch_type == "hybrid" and c.global_attn_every:
                    win = None if li % c.global_attn_every == 0 \
                        else c.sliding_window
                else:
                    win = c.sliding_window or None
                yield g, s, li, win

    def _prepend_context(self, x: torch.Tensor, positions: torch.Tensor):
        """Prepend the meta tokens (hymba): returns (x, positions, n_lead),
        the prepended tokens at positions 0..n_lead-1 and the text's
        shifted up by n_lead. vlm's prefix embeddings and M-RoPE grid
        arrive with the vlm slice (``Model`` refuses vlm configs)."""
        c = self.config
        if c.n_meta_tokens == 0:
            return x, positions, 0
        b, n_lead = x.shape[0], c.n_meta_tokens
        meta = self.meta_tokens[None].expand(b, -1, -1).to(x.dtype)
        lead_pos = torch.arange(n_lead, dtype=positions.dtype,
                                device=positions.device).expand(b, n_lead)
        return (torch.cat([meta, x], dim=1),
                torch.cat([lead_pos, positions + n_lead], dim=1), n_lead)

    # ------------------------------------------------------------------ #
    # full-sequence forward (prefill)
    # ------------------------------------------------------------------ #
    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False,
                cache_size: int | None = None,
                logits_last_only: bool = False):
        """tokens (B, L) -> logits (B, L, Vp), or (B, 1, Vp) with
        ``logits_last_only``; with ``collect_cache`` also the prefill's
        ``DecodeCaches``: KV caches sized ``cache_size`` (default the
        prefill's length, meta tokens included), a padded copy in the front
        of the cache or a ring holding the last ``cache_size`` positions;
        SSM states after the last position. The JAX forward also returns
        the MoE auxiliary loss, which is not returned here."""
        c = self.config
        b, l_text = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(l_text, dtype=torch.int32,
                                 device=tokens.device).expand(b, l_text)
        x, positions, n_lead = self._prepend_context(x, positions)
        l = x.shape[1]
        ks, vs, convs, ssds = [], [], [], []
        for g, s, _, win in self._layers():
            xn = rms_norm(x, self.blocks["norm1"][g, s])
            if c.has_ssm:
                out = ssm_forward(self._ssm_params(g, s), xn, c,
                                  return_state=collect_cache)
                if collect_cache:
                    out, conv, ssd = out
                    convs.append(conv)
                    ssds.append(ssd)
            if c.has_attention:
                q, k, v = self._qkv(g, s, xn, positions)
                o = blockwise_attention(q, k, v, causal=True, window=win,
                                        n_sink=c.n_meta_tokens)
                attn = o.reshape(b, l, -1) @ self.blocks["wo"][g, s]
                if collect_cache:
                    ks.append(k)
                    vs.append(v)
            if c.arch_type == "hybrid":   # per-branch norm, then the mean
                fused = 0.5 * (_branch_norm(attn) + _branch_norm(out))
                x = x + fused.to(x.dtype)
            else:
                x = x + (attn if c.has_attention else out)
            y = self._ffn(g, s, x)
            if y is not None:
                x = x + y
        logits = self._head(x[:, -1:] if logits_last_only else x[:, n_lead:])
        if not collect_cache:
            return logits
        kv = self._prefill_kv(ks, vs, l, cache_size) if ks else None
        ssm = SSMState(conv=torch.stack(convs), ssd=torch.stack(ssds)) \
            if convs else None
        return logits, DecodeCaches(kv=kv, ssm=ssm)

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
        """One token for every sequence: tokens (B, 1) -> logits (B, 1, Vp)
        and the caches one position on.

        The caches' K/V and SSM tensors are updated in place and returned
        in the new ``DecodeCaches``. As in JAX, every layer's
        ``cache_write`` gets the step's un-updated ``slot_pos``, and the
        new one is written once at the end. A global layer passes
        ``window=None`` where JAX passes its traced ``2**30``; both give
        the same visibility. Without a KV cache (ssm) the step has no
        position, as JAX's ``_ssm_pos`` gives 0: nothing reads it."""
        c = self.config
        b = tokens.shape[0]
        kv, st = caches.kv, caches.ssm
        pos = kv.pos if kv is not None else 0
        quant = kv is not None and kv.quantized
        x = self.embed[tokens]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=tokens.device)
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
            y = self._ffn(g, s, x)
            if y is not None:
                x = x + y
        logits = self._head(x)
        new_kv = None
        if kv is not None:
            new_slot = slot_pos.clone()
            new_slot[pos % kv.size] = pos
            new_kv = KVCache(k=kv.k, v=kv.v, slot_pos=new_slot, pos=pos + 1,
                             k_scale=kv.k_scale, v_scale=kv.v_scale)
        return logits, DecodeCaches(kv=new_kv, ssm=st)
