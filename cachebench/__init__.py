"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
semantic cache in front of a hosted model, under the paper's query mix.
``run.py`` is the entry point; ``README.md`` describes the layout."""
