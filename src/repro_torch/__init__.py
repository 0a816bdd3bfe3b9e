"""GPT Semantic Cache on PyTorch and CUDA.

The PyTorch counterpart of ``repro`` (the JAX package, which stays the
reference). The layout mirrors ``repro``: ``core`` (slab, index, policy,
cache), ``kernels`` (the hand-written CUDA cosine top-k and its plain
PyTorch version), ``serving`` (engine, simulated backend, metrics),
``data``/``embedding`` (numpy-only corpus, tokenizer and embedder),
``training`` (checkpoint format) and ``launch`` (the serve driver).

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when CUDA is absent; pass ``device="cpu"`` to run the plain
PyTorch path on the CPU.
"""
