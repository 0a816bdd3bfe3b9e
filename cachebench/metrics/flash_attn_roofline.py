"""flash_attn_roofline: the prefill flash-attention kernel's share of its
roofline (``csrc/flash_attention.cu``: ``flash_attention_bf16_kernel``),
from the profiler's device time; attention kernels."""
from cachebench.metrics._roofline import share


def read(view):
    return share(view, 0, lambda n: "flash_attention" in n)
