"""Kernels of the port: each is hand-written CUDA for Hopper (``csrc/``),
built at first use (``build``), launched by a wrapper that counts its
launches, and paired with a plain PyTorch version in ``ref``. ``ops``
dispatches by the device of the tensors."""
