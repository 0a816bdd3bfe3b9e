"""Kernels of the port: each is hand-written CUDA for Hopper (``csrc/``),
built at first use (``build``), launched by a wrapper that counts its
launches, and paired with a plain PyTorch version in ``ref``. ``ops``
dispatches by the device of the tensors."""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.cosine_topk import (cosine_topk_cuda,
                                             cosine_topk_interval_cuda,
                                             cosine_topk_masked_cuda,
                                             quant_cosine_topk_cuda,
                                             quant_cosine_topk_interval_cuda,
                                             quant_cosine_topk_masked_cuda,
                                             quantize_keys)
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ivf_topk import ivf_topk_cuda

# the reference's ``*_pallas`` kernels are the port's ``*_cuda`` wrappers
__all__ = ["ops", "ref", "cosine_topk_cuda", "cosine_topk_interval_cuda",
           "cosine_topk_masked_cuda", "quant_cosine_topk_cuda",
           "quant_cosine_topk_interval_cuda", "quant_cosine_topk_masked_cuda",
           "quantize_keys", "ivf_topk_cuda", "flash_attention_cuda",
           "decode_attention_cuda"]
