"""decode_attn_roofline: the decode-attention kernel's share of its
roofline (``csrc/decode_attention.cu``: ``decode_tc_kernel``,
``decode_core_kernel`` and the split merge ``decode_merge_kernel``),
from the profiler's device time; attention kernels."""
from cachebench.metrics._roofline import share


def read(view):
    return share(view, 1, lambda n: "decode_" in n and "_kernel" in n)
