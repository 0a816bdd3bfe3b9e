"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (PyTorch port
of ``repro.models.ssm``).

Layer = in_proj -> causal depthwise conv (x, B, C) -> SiLU -> SSD -> gated
RMSNorm (y * silu(z)) -> out_proj. The full-sequence form is the chunked
SSD dual form: within a chunk of Q positions an attention-like quadratic
term, across chunks a recurrence on the (H, P, N) state (a loop over
chunks stands in for the reference's ``lax.scan``). Decode is the
recurrent form, S <- exp(dt A) S + dt B x, y = C S + D x, with a
(d_conv - 1)-deep conv state: O(1) a token, no KV cache.

The JAX package runs all of it in plain jnp, outside any Pallas kernel, so
it is plain PyTorch here (``torch.einsum`` / matmul), with the reference's
rounding points: the projections in the model's dtype, the conv, scan and
gated ``rms_norm`` in f32, ``out_proj``'s input cast back to the model's
dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm


def ssm_dims(config: ModelConfig) -> dict:
    d_inner = config.d_inner
    h = config.ssm_nheads
    g, n = config.ssm_ngroups, config.ssm_state
    conv_dim = d_inner + 2 * g * n
    in_dim = 2 * d_inner + 2 * g * n + h   # z, xBC, dt
    return dict(d_inner=d_inner, nheads=h, ngroups=g, state=n,
                conv_dim=conv_dim, in_dim=in_dim, headdim=config.ssm_headdim)


def _split_proj(zxbcdt: torch.Tensor, dims: dict):
    d_inner, conv_dim = dims["d_inner"], dims["conv_dim"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Depthwise causal conv. x (B, L, C), w (K, C), b (C,); the taps
    summed in the reference's order (a bf16 x meets the f32 taps in f32)."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + l, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _segsum_exp(a_cum: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(a_cum[i] - a_cum[j]) for i >= j, else 0. a_cum (..., Q).
    Above the diagonal the differences are positive and their exp may be
    inf; ``where`` selects 0 there, so no inf * 0 is formed."""
    q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=a_cum.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, d_skip: torch.Tensor,
             chunk: int, init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x (B, L, H, P); dt (B, L, H) (after softplus); a (H,)
    (negative); b_mat, c_mat (B, L, G, N); d_skip (H,). Returns (y (B, L,
    H, P) f32, final_state (B, H, P, N) f32). L is padded to a chunk
    multiple with dt = 0 rows, which leave the state as it was."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, l)
    l_orig = l
    if l % q:
        pad = q - l % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        l = l + pad
    nc = l // q

    f32 = torch.float32
    xr = x.reshape(bsz, nc, q, h, p).to(f32)
    dtr = dt.reshape(bsz, nc, q, h).to(f32)
    br = b_mat.reshape(bsz, nc, q, g, n).repeat_interleave(rep, dim=3).to(f32)
    cr = c_mat.reshape(bsz, nc, q, g, n).repeat_interleave(rep, dim=3).to(f32)
    a_cum = torch.cumsum(dtr * a[None, None, None, :], dim=2)   # (B,nc,Q,H)

    state = init_state if init_state is not None else \
        torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xr[:, ci], dtr[:, ci], br[:, ci], cr[:, ci]
        a_cumc = a_cum[:, ci]                                   # (B,Q,H)
        lmat = _segsum_exp(a_cumc.transpose(1, 2))              # (B,H,Q,Q)
        # intra-chunk: scores[i, j] = C_i . B_j * L[i, j] * dt_j
        scores = torch.einsum("bihn,bjhn->bhij", cc, bc) * lmat
        scores = scores * dtc.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xc)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bihn,bhpn->bihp", cc, state) \
            * torch.exp(a_cumc)[..., None]
        # S' = exp(a_sum) S + sum_j exp(a_sum - a_cum[j]) dt_j B_j x_j^T
        a_sum = a_cumc[:, -1]                                   # (B,H)
        decay = torch.exp(a_sum[:, None] - a_cumc) * dtc        # (B,Q,H)
        ds = torch.einsum("bjh,bjhn,bjhp->bhpn", decay, bc, xc)
        state = torch.exp(a_sum)[..., None, None] * state + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, l, h, p)
    y = y + x.to(f32) * d_skip[None, None, :, None]
    return y[:, :l_orig], state


@dataclasses.dataclass
class SSMState:
    """Decode-time recurrent state, layers stacked on the leading axis.
    ``Model.decode_step`` updates both tensors in place, as it does the
    KV cache."""

    conv: torch.Tensor   # (L, B, K-1, conv_dim) f32 conv state
    ssd: torch.Tensor    # (L, B, H, P, N) f32 SSD state


def init_ssm_state(config: ModelConfig, batch: int, device=None) -> SSMState:
    dims = ssm_dims(config)
    l = config.n_layers
    return SSMState(
        conv=torch.zeros((l, batch, config.ssm_conv - 1, dims["conv_dim"]),
                         dtype=torch.float32, device=device),
        ssd=torch.zeros((l, batch, dims["nheads"], dims["headdim"],
                         dims["state"]), dtype=torch.float32, device=device))


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """rms_norm(y * silu(z)) in f32, then out_proj in the model's dtype."""
    y = rms_norm(y * F.silu(z.to(torch.float32)), params["norm_w"])
    return y.to(dtype) @ params["out_proj"]


def ssm_forward(params: dict, x: torch.Tensor, config: ModelConfig,
                return_state: bool = False):
    """Full-sequence forward of one SSM layer. x (B, L, d_model).

    With ``return_state`` also returns (conv_state (B, K-1, conv_dim),
    ssd_state (B, H, P, N)), both f32: the decode-continuation states
    after the last position (a prefill shorter than K-1 is left-padded
    with zeros)."""
    dims = ssm_dims(config)
    z, xbc_raw, dt = _split_proj(x @ params["in_proj"], dims)
    xbc = F.silu(causal_conv1d(xbc_raw, params["conv_w"], params["conv_b"]))
    d_inner, g, n = dims["d_inner"], dims["ngroups"], dims["state"]
    h, p = dims["nheads"], dims["headdim"]
    bsz, l = xbc.shape[:2]
    x_ssm = xbc[..., :d_inner].reshape(bsz, l, h, p)
    b_mat = xbc[..., d_inner:d_inner + g * n].reshape(bsz, l, g, n)
    c_mat = xbc[..., d_inner + g * n:].reshape(bsz, l, g, n)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"].to(torch.float32))
    y, final_state = ssd_scan(x_ssm, dt, a, b_mat, c_mat, params["d_skip"],
                              config.ssm_chunk)
    out = _gated_out(params, y.reshape(bsz, l, d_inner), z, x.dtype)
    if not return_state:
        return out
    km1 = config.ssm_conv - 1
    conv_state = xbc_raw[:, -km1:, :].to(torch.float32)
    if l < km1:
        conv_state = F.pad(conv_state, (0, 0, km1 - l, 0))
    return out, conv_state, final_state


def ssm_decode_step(params: dict, x: torch.Tensor, conv_state: torch.Tensor,
                    ssd_state: torch.Tensor, config: ModelConfig):
    """One-token recurrent step. x (B, 1, d_model); conv_state (B, K-1,
    conv_dim), ssd_state (B, H, P, N), f32. Returns (y (B, 1, d_model),
    new_conv_state, new_ssd_state), new tensors."""
    dims = ssm_dims(config)
    z, xbc_new, dt = _split_proj(x @ params["in_proj"], dims)
    window = torch.cat([conv_state, xbc_new.to(torch.float32)], dim=1)
    xbc = torch.einsum("bkc,kc->bc", window, params["conv_w"]) \
        + params["conv_b"]
    xbc = F.silu(xbc)[:, None, :]                               # (B, 1, C)
    new_conv = window[:, 1:, :]

    d_inner, g, n = dims["d_inner"], dims["ngroups"], dims["state"]
    h, p = dims["nheads"], dims["headdim"]
    rep = h // g
    f32 = torch.float32
    x_ssm = xbc[..., :d_inner].reshape(-1, h, p).to(f32)
    b_h = xbc[..., d_inner:d_inner + g * n].reshape(-1, g, n) \
        .repeat_interleave(rep, dim=1).to(f32)                  # (B, H, N)
    c_h = xbc[..., d_inner + g * n:].reshape(-1, g, n) \
        .repeat_interleave(rep, dim=1).to(f32)
    dt1 = F.softplus(dt[:, 0].to(f32) + params["dt_bias"])     # (B, H)
    a = -torch.exp(params["a_log"].to(f32))
    decay = torch.exp(dt1 * a[None, :])
    ds = torch.einsum("bh,bhn,bhp->bhpn", dt1, b_h, x_ssm)
    new_ssd = decay[..., None, None] * ssd_state + ds
    y = torch.einsum("bhn,bhpn->bhp", c_h, new_ssd)
    y = y + x_ssm * params["d_skip"][None, :, None]
    out = _gated_out(params, y.reshape(x.shape[0], 1, d_inner), z, x.dtype)
    return out, new_conv, new_ssd
