"""repro_torch.train — grid-independent checkpoints (the JAX package's
format)."""
from .checkpoint import (CheckpointError, latest_step, restore_checkpoint,
                         restore_flat, save_checkpoint)
