"""Generative near-hit cache: tiered threshold bands + answer synthesis
from top-k neighbours (DESIGN.md §17), PyTorch port of
``repro.generative``."""
from repro_torch.generative.policy import BandPolicy
from repro_torch.generative.synthesize import (
    Neighbour,
    SmallModelRewrite,
    SmallRewriteBackend,
    Synthesis,
    Synthesizer,
    TemplateSplice,
    rewrite_prompt,
)

__all__ = [
    "BandPolicy",
    "Neighbour",
    "SmallModelRewrite",
    "SmallRewriteBackend",
    "Synthesis",
    "Synthesizer",
    "TemplateSplice",
    "rewrite_prompt",
]
