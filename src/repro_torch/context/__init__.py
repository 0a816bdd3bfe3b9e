"""Session subsystem: context-aware multi-turn caching (DESIGN.md §16),
PyTorch port of ``repro.context``.

``SessionStore`` (host) keeps per-session ring buffers of turn embeddings;
``ContextFusion`` strategies (device) pool a ``(B, W, d)`` window of them
into the ``(B, d)`` lookup key before the cache's search and insert, so
semantically equivalent *dialogue states* hit where isolated follow-up
texts never could.
"""
from repro_torch.context.fusion import (AttentionFusion, ContextFusion,
                                        DecayMeanFusion, FusionState, fuse_op)
from repro_torch.context.session import SessionStore

__all__ = ["AttentionFusion", "ContextFusion", "DecayMeanFusion",
           "FusionState", "SessionStore", "fuse_op"]
