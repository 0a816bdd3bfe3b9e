"""GPT Semantic Cache on PyTorch and CUDA.

The PyTorch counterpart of ``repro`` (the JAX package, which stays the
reference). The layout mirrors ``repro``: ``core`` (slab, index, policy,
cache), ``kernels`` (the hand-written CUDA kernels and their plain PyTorch
versions), ``serving`` (engine, simulated and model backends, metrics),
``configs``/``models`` (the architectures and the dense decoder behind
the model-backed miss path),
``data``/``embedding`` (numpy-only corpus, tokenizer and hash embedder;
the MiniLM encoder),
``training`` (optimizer, checkpoint format) and ``launch`` (the serve and
train drivers, the roofline model and the shape dry run).

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when CUDA is absent; pass ``device="cpu"`` to run the plain
PyTorch path on the CPU.
"""
