"""The arithmetic of the shared-mask cosine top-k's tensor-core form
(``csrc/cosine_topk.cu``, ``cosine_topk_tc``), emulated on the CPU, where the
kernel cannot run.

The kernel splits each f32 operand x into hi = TF32(x) (rounded to nearest,
ties away from zero, by integer operations on the bits) and lo = x - hi,
whose low 13 bits the tensor cores drop, and sums a_lo b_hi + a_hi b_lo +
a_hi b_hi in m16n8k8 products of 8 dims into a fresh f32 sum per 32-dim
slice, added across slices in f32. int8 keys enter as they are stored (exact
in TF32: two products, a_lo k + a_hi k) and their scale multiplies the sum.
Emulated here with each product of 8 dims exact (float64) and rounded to f32
once: on seeded unit vectors at d=384 and d=1536, half of the queries near a
key (scores about 0.8, where hit decisions are made), the scores stay within
2e-6 of the f32 product, while TF32 alone (a_hi b_hi) errs by more than
1.85e-5, the distance of the paper configuration's closest score from the
0.8 threshold (PERF.md)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cosine_topk as kmod

SLICE = 32   # dims summed into one fresh sum (DK in the source)
STEP = 8     # dims of one m16n8k8 product
THRESHOLD_MARGIN = 1.85e-5


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bits: 10 mantissa bits, ties away from 0."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_drop(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores take of an f32 operand: its low 13 bits
    dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_round(x)
    return hi, tf32_drop(x - hi)


def emulate(q: torch.Tensor, keys: torch.Tensor, terms) -> torch.Tensor:
    """(B, N) f32 scores: for each 32-dim slice a fresh f32 sum of the
    ``terms`` (pairs of (B, d) and (N, d) operands) over products of 8 dims,
    each exact and rounded to f32 as it is added; slices added in f32."""
    d = q.shape[1]
    acc = torch.zeros(q.shape[0], keys.shape[0])
    for c0 in range(0, d, SLICE):
        part = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + SLICE, d), STEP):
            dims = slice(k0, k0 + STEP)
            for a, b in terms:
                prod = a[:, dims].double() @ b[:, dims].double().T
                part = (part.double() + prod).float()
        acc = acc + part
    return acc


def inputs(d: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """32 unit queries, half of them a unit key plus noise (scores near
    0.8), and 1,024 unit keys."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((1024, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    q = rng.standard_normal((32, d)).astype(np.float32)
    q[:16] = keys[:16] + 0.75 * q[:16] / np.linalg.norm(q[:16], axis=1,
                                                          keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q), torch.from_numpy(keys)


def test_tf32_rounding_on_the_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 2.0 ** -130, 0.0])
    # ties (1 + 2^-11 lies halfway between 1 and 1 + 2^-10) go away from 0
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 2.0 ** -130, 0.0])
    assert torch.equal(tf32_round(x), want)
    # lo = 2^-12 (1 + 2^-11) needs 12 bits: the tensor cores see 2^-12
    hi, lo = split(torch.tensor([1.0 + 2.0 ** -12 + 2.0 ** -23]))
    assert hi.item() == 1.0 and lo.item() == 2.0 ** -12


@pytest.mark.parametrize("key_form", ["f32", "int8", "int8_row_scale"])
@pytest.mark.parametrize("d", [384, 1536])
def test_3xtf32_scores_stay_within_2e6_of_f32(d, key_form):
    q, keys = inputs(d, seed=d)
    qh, ql = split(q)
    if key_form == "f32":
        plain = q @ keys.T
        kh, kl = split(keys)
        got = emulate(q, keys, [(ql, kh), (qh, kl), (qh, kh)])
        tf32_alone = emulate(q, keys, [(qh, tf32_round(keys))])
    else:
        if key_form == "int8":
            kq = torch.clamp(torch.round(keys * 127.0), -127, 127)
            scale = torch.full((keys.shape[0],), 1.0 / 127.0)
        else:
            kq8, scale = kmod.quantize_keys(keys)
            kq = kq8.float()
        # the plain version's operands: each key times its scale, rounded
        plain = q @ (kq * scale[:, None]).T
        got = emulate(q, kq, [(ql, kq), (qh, kq)]) * scale[None, :]
        tf32_alone = emulate(q, kq, [(qh, kq)]) * scale[None, :]
    err = (got - plain).abs().max().item()
    assert err <= 2e-6, err
    assert (tf32_alone - plain).abs().max().item() > THRESHOLD_MARGIN
    # the near-key queries score about 0.8, where decisions are made
    assert 0.7 < plain[:16].max(dim=1).values.min().item() < 0.9
