"""Training: AdamW (``optimizer``) and checkpoints in the format shared
with ``repro.training.checkpoint`` (``checkpoint``)."""

from repro_torch.training.checkpoint import (CheckpointCorruptError,
                                             load_checkpoint, open_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, global_norm,
                                            init_adamw, lr_at,
                                            make_train_step)

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "init_adamw",
           "lr_at", "make_train_step", "global_norm", "load_checkpoint",
           "save_checkpoint", "open_checkpoint", "CheckpointCorruptError"]
