"""The FLOP and byte counts against hand counts at small shapes, and the
miss path's count against the products the plain reference runs."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cachebench import counts, refmodel

DENSE = {"name": "t", "arch_type": "dense", "n_layers": 2, "d_model": 16,
         "n_heads": 4, "n_kv_heads": 2, "head_dim": 8, "d_ff": 24,
         "vocab": 40, "dtype": "float32", "vocab_pad_multiple": 8}
MOE = dict(DENSE, arch_type="moe", n_experts=4, moe_topk=2)


def test_decode_launch_by_hand():
    # 2 rows, 4 query heads over 5 held positions of 2 KV heads, D = 8
    flops, byts = counts.decode_launch(2, 4, 2, 8, 5)
    assert flops == 2 * 4 * 5 * (2 * 8 + 2 * 8)       # q.k and p.v
    assert byts == 2 * (2 * 2 * 5 * 2 * 8 + 2 * 2 * 4 * 8)


def test_flash_launch_by_hand():
    # 1 row of 3 causal positions: 6 visible pairs, 2 heads, 1 KV head
    flops, byts = counts.flash_launch(1, 3, 2, 1, 4)
    assert flops == 2 * 6 * (2 * 4 + 2 * 4)
    assert byts == 2 * 3 * 4 * (2 + 2 + 1 + 1)


def test_roofline_takes_the_larger_bound():
    assert counts.roofline_s(989e12, 1.0) == pytest.approx(1.0)
    assert counts.roofline_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_attention_bounds_sum_launches():
    pre, dec = counts.attention_bounds(DENSE, 3, 4, 3)
    f, b = counts.flash_launch(3, 4, 4, 2, 8)
    assert pre == pytest.approx(2 * 2 * counts.roofline_s(f, b))
    want = 2 * sum(counts.roofline_s(*counts.decode_launch(3, 4, 2, 8, 5 + j))
                   for j in range(2))
    assert dec == pytest.approx(want)
    assert counts.attention_bounds(DENSE, 0, 4, 3) == (0.0, 0.0)


@pytest.mark.parametrize("model", [DENSE, MOE], ids=["dense", "moe"])
def test_generate_flops_match_the_reference_products(model):
    """The reference feeds prompt + served tokens once and takes the head
    where tokens are chosen: its matrix products are the count's, less
    the attention scores (its einsum scores every pair, the count only
    the causal ones) and, for experts, what capacity drops."""
    b, p, n = 3, 6, 4
    w = refmodel.Weights(model, 0, "cpu")
    prompts = torch.randint(8, model["vocab"], (b, p))
    served = torch.randint(8, model["vocab"], (b, n))
    with FlopCounterMode(display=False) as fc:
        refmodel.teacher_logits(w, model, prompts, served)
    by_op = fc.get_flop_counts()["Global"]
    mm = sum(v for k, v in by_op.items() if "mm" in str(k)
             and "bmm" not in str(k))
    l, h, hd = p + n - 1, model["n_heads"], model["head_dim"]
    pairs = p * (p + 1) / 2 + sum(p + 1 + j for j in range(n - 1))
    att = model["n_layers"] * 4 * h * hd * pairs * b
    want = counts.generate_flops(model, b, p, n) - att
    if model.get("n_experts"):
        assert mm <= want       # dropped (token, expert) pairs run nothing
        assert mm >= 0.6 * want
    else:
        assert mm == pytest.approx(want)
    assert l == p + n - 1
