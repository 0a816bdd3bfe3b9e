"""The decoder behind the model-backed miss path (PyTorch port of the dense
branches of ``repro.models.model``).

``Model`` is an ``nn.Module`` whose parameters keep the JAX parameter
tree's names and its stacked per-layer layout: ``embed`` (Vp, d),
``lm_head`` (d, Vp), ``final_norm`` (d,) f32 and ``blocks.<name>`` with a
leading (layer group, slot) pair of axes, e.g. ``blocks.wq`` (n_layers, 1,
d, H*hd). So ``convert.params_from_jax`` is a renaming, and one
``load_state_dict`` carries the JAX package's weights across.

Two entry points, as in JAX:
  ``forward``      — full-sequence logits, optionally with the KV caches
                     of the prefill (attention through the flash-attention
                     kernel on CUDA);
  ``decode_step``  — one token against the caches (attention through the
                     decode-attention kernel on CUDA).
The projections, norms, RoPE and MLP are plain PyTorch (the GEMMs go to
``torch.matmul``, as the JAX package leaves them to XLA), with the JAX
package's rounding points: f32 norms cast back, bf16 residual adds.

Only the dense family runs here. MoE, SSM, hybrid, audio and VLM configs
raise ``NotImplementedError`` naming the slice of the port that brings
them.
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
from repro_torch.models.layers import rms_norm, rope_for, swiglu, unembed

_LATER = {"moe": "the moe slice", "ssm": "the ssm slice",
          "hybrid": "the hybrid slice", "audio": "the audio slice",
          "vlm": "the vlm slice"}


@dataclasses.dataclass
class DecodeCaches:
    """Everything ``decode_step`` threads through: the KV cache (the SSM
    state of JAX's ``DecodeCaches`` arrives with the ssm slice)."""

    kv: KVCache


def _dtype(config: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


class Model(nn.Module):
    """Config-driven dense decoder. Its parameters are allocated, not drawn:
    call ``init_params`` (random init) or ``load_state_dict`` (e.g. of
    ``convert.params_from_jax``) before use. ``device`` defaults to CUDA and
    raises without it; pass ``device="cpu"`` for the plain path."""

    def __init__(self, config: ModelConfig, *, device="cuda"):
        super().__init__()
        c = config
        if c.arch_type != "dense":
            raise NotImplementedError(
                f"{c.name}: the {c.arch_type} family arrives with "
                f"{_LATER[c.arch_type]} of the port; only dense models run")
        self.config = c
        self.device = resolve_device(device)
        self.n_groups = c.n_layers // c.moe_interleave
        self.interleave = c.moe_interleave
        self.n_mlp_slots = self.interleave if c.d_ff > 0 else 0
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
        blocks = {"norm1": param((g, i, d), torch.float32),
                  "wq": param((g, i, d, h * hd)),
                  "wk": param((g, i, d, hkv * hd)),
                  "wv": param((g, i, d, hkv * hd)),
                  "wo": param((g, i, h * hd, d))}
        if self.n_mlp_slots > 0:
            m = self.n_mlp_slots
            blocks.update(norm2=param((g, m, d), torch.float32),
                          mlp_gate=param((g, m, d, ff)),
                          mlp_up=param((g, m, d, ff)),
                          mlp_down=param((g, m, ff, d)))
        self.blocks = nn.ParameterDict(blocks)

    # ------------------------------------------------------------------ #
    # parameter construction
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Random init with the JAX package's scales: normal x scale drawn
        in f32 on the module's device from ``generator`` (which must live
        there), cast to the config's dtype; norms are ones. The numbers
        differ from JAX's ``init_params``; tests carry JAX's across."""
        c = self.config
        d, hd = c.d_model, c.head_dim

        def nrm(p, scale):
            p.copy_(torch.randn(p.shape, generator=generator,
                                dtype=torch.float32, device=self.device)
                    * scale)

        nrm(self.embed, 0.02)
        nrm(self.lm_head, d ** -0.5)
        self.final_norm.fill_(1.0)
        b = self.blocks
        b["norm1"].fill_(1.0)
        nrm(b["wq"], d ** -0.5)
        nrm(b["wk"], d ** -0.5)
        nrm(b["wv"], d ** -0.5)
        nrm(b["wo"], (c.n_heads * hd) ** -0.5)
        if self.n_mlp_slots > 0:
            b["norm2"].fill_(1.0)
            nrm(b["mlp_gate"], d ** -0.5)
            nrm(b["mlp_up"], d ** -0.5)
            nrm(b["mlp_down"], c.d_ff ** -0.5)
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

    def _ffn(self, g: int, s: int, x: torch.Tensor) -> torch.Tensor:
        lp = self.blocks
        xn = rms_norm(x, lp["norm2"][g, s])
        return swiglu(xn, lp["mlp_gate"][g, s], lp["mlp_up"][g, s],
                      lp["mlp_down"][g, s])

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm)
        return unembed(x, self.lm_head, self.config.vocab)

    def _layers(self):
        """(group, slot, layer index, attention window or None) in order.
        Dense configs share one window (``sliding_window``, else global);
        per-layer windows arrive with the hybrid slice."""
        win = self.config.sliding_window or None
        for g in range(self.n_groups):
            for s in range(self.interleave):
                yield g, s, g * self.interleave + s, win

    # ------------------------------------------------------------------ #
    # full-sequence forward (prefill)
    # ------------------------------------------------------------------ #
    def forward(self, tokens: torch.Tensor, *, collect_cache: bool = False,
                cache_size: int | None = None,
                logits_last_only: bool = False):
        """tokens (B, L) -> logits (B, L, Vp), or (B, 1, Vp) with
        ``logits_last_only``; with ``collect_cache`` also the prefill's
        ``DecodeCaches`` sized ``cache_size`` (default L): a padded copy in
        the front of the cache, or a ring holding the last ``cache_size``
        positions. The JAX forward also returns an MoE auxiliary loss,
        which is 0 for dense models and is not returned here."""
        c = self.config
        b, l = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(l, dtype=torch.int32,
                                 device=tokens.device).expand(b, l)
        ks, vs = [], []
        for g, s, _, win in self._layers():
            xn = rms_norm(x, self.blocks["norm1"][g, s])
            q, k, v = self._qkv(g, s, xn, positions)
            o = blockwise_attention(q, k, v, causal=True, window=win,
                                    n_sink=c.n_meta_tokens)
            x = x + o.reshape(b, l, -1) @ self.blocks["wo"][g, s]
            if collect_cache:
                ks.append(k)
                vs.append(v)
            if s < self.n_mlp_slots:
                x = x + self._ffn(g, s, x)
        logits = self._head(x[:, -1:] if logits_last_only else x)
        if not collect_cache:
            return logits
        return logits, self._build_prefill_caches(ks, vs, l, cache_size)

    def _build_prefill_caches(self, ks: list, vs: list, l_total: int,
                              cache_size: int | None) -> DecodeCaches:
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
        return DecodeCaches(kv=KVCache(k=k.contiguous(), v=v.contiguous(),
                                       slot_pos=slot_pos, pos=l_total))

    # ------------------------------------------------------------------ #
    # decode
    # ------------------------------------------------------------------ #
    def init_decode_caches(self, batch: int, cache_size: int,
                           kv_quantized: bool = False) -> DecodeCaches:
        c = self.config
        return DecodeCaches(kv=init_kv_cache(
            c.n_layers, batch, cache_size, c.n_kv_heads, c.head_dim,
            dtype=_dtype(c), quantized=kv_quantized, device=self.device))

    def decode_step(self, caches: DecodeCaches, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, DecodeCaches]:
        """One token for every sequence: tokens (B, 1) -> logits (B, 1, Vp)
        and the caches one position on.

        The caches' K/V tensors are updated in place and returned in the
        new ``DecodeCaches``. As in JAX, every layer's ``cache_write`` gets
        the step's un-updated ``slot_pos``, and the new one is written once
        at the end. A global layer passes ``window=None`` where JAX passes
        its traced ``2**30``; both give the same visibility."""
        c = self.config
        b = tokens.shape[0]
        kv = caches.kv
        pos = kv.pos
        quant = kv.quantized
        x = self.embed[tokens]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=tokens.device)
        slot_pos = kv.slot_pos
        for g, s, li, win in self._layers():
            xn = rms_norm(x, self.blocks["norm1"][g, s])
            q, k1, v1 = self._qkv(g, s, xn, positions)
            kc, vc, sp, ksc, vsc = cache_write(
                kv.k[li], kv.v[li], slot_pos, k1, v1, pos,
                kv.k_scale[li] if quant else None,
                kv.v_scale[li] if quant else None)
            o = decode_attention(q, kc, vc, sp, pos, window=win,
                                 n_sink=c.n_meta_tokens, k_scale=ksc,
                                 v_scale=vsc)
            x = x + o.reshape(b, 1, -1) @ self.blocks["wo"][g, s]
            if s < self.n_mlp_slots:
                x = x + self._ffn(g, s, x)
        logits = self._head(x)
        new_slot = slot_pos.clone()
        new_slot[pos % kv.size] = pos
        return logits, DecodeCaches(kv=KVCache(
            k=kv.k, v=kv.v, slot_pos=new_slot, pos=pos + 1,
            k_scale=kv.k_scale, v_scale=kv.v_scale))
