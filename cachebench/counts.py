"""Operations and bytes that the served work needs, from shapes alone, and
the chip's peaks: the yardstick of ``step_mfu`` and the attention
kernels' roofline shares.

What is counted is what the inputs need, not what the program happens to
run: one prefill of each batch of misses (a second full forward is not
work the answer needs), the logits of the positions that choose a token,
attention over the positions a cache actually holds, and for a mixture
of experts the ``moe_topk`` experts each token is routed to. A prompt is
the padded ``max_prompt_len`` tokens, since the padding is part of what
the model is given.

Imports nothing of the program.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, dense rates (data sheet), at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def decode_launch(b: int, h: int, hkv: int, d: int, held: int
                  ) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention launch: ``b`` rows, each
    query of ``h`` heads against ``held`` cached positions of ``hkv``
    heads. Bytes: K and V read once, q read and the output written."""
    flops = 4.0 * b * h * held * d
    byts = BF16 * (2.0 * b * held * hkv * d + 2.0 * b * h * d)
    return flops, byts


def flash_launch(b: int, l: int, h: int, hkv: int, d: int
                 ) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal prefill-attention launch over ``l``
    positions: the visible (query, key) pairs, q, k, v read once, the
    output written once."""
    pairs = l * (l + 1) / 2.0
    flops = 4.0 * b * h * d * pairs
    byts = BF16 * b * l * d * (2.0 * h + 2.0 * hkv)
    return flops, byts


def roofline_s(flops: float, byts: float) -> float:
    """The least time the chip needs: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, byts / PEAK_HBM_BYTES)


def _dense_per_token(model: dict) -> float:
    """Matrix FLOPs a token needs in one layer, attention scores aside."""
    d, h, hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd, ff = model.get("head_dim", 128), model["d_ff"]
    proj = 2.0 * d * hd * (2 * h + 2 * hkv)
    if model.get("n_experts", 0) > 0:
        ffn = 2.0 * d * model["n_experts"] + \
            model["moe_topk"] * 6.0 * d * ff
    else:
        ffn = 6.0 * d * ff
    return proj + ffn


def generate_flops(model: dict, misses: int, prompt_len: int,
                   new_tokens: int) -> float:
    """FLOPs that one batch of ``misses`` rows needs: one prefill of the
    prompts, ``new_tokens - 1`` decode steps, the logits of the
    ``new_tokens`` positions that choose a token."""
    if misses == 0:
        return 0.0
    layers = model["n_layers"]
    h, hd = model["n_heads"], model.get("head_dim", 128)
    per_tok = _dense_per_token(model)
    steps = new_tokens - 1
    tokens = prompt_len + steps
    att_pairs = prompt_len * (prompt_len + 1) / 2.0 + sum(
        prompt_len + 1 + j for j in range(steps))
    per_row = layers * (tokens * per_tok + 4.0 * h * hd * att_pairs)
    per_row += new_tokens * 2.0 * model["d_model"] * model["vocab"]
    return misses * per_row


def attention_bounds(model: dict, misses: int, prompt_len: int,
                     new_tokens: int) -> tuple[float, float]:
    """Roofline seconds of the attention-kernel launches one batch of
    ``misses`` rows runs, summed launch by launch: (prefill, decode). The
    program runs the prefill twice (caches, then the first token's
    logits); each of its launches is counted, as the kernels' time is."""
    if misses == 0:
        return 0.0, 0.0
    layers = model["n_layers"]
    h, hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim", 128)
    prefill = 2 * layers * roofline_s(*flash_launch(misses, prompt_len, h,
                                                    hkv, hd))
    decode = layers * sum(
        roofline_s(*decode_launch(misses, h, hkv, hd, prompt_len + 1 + j))
        for j in range(new_tokens - 1))
    return prefill, decode
