"""repro_torch.train — grid-independent checkpoints (the JAX package's
format) and synthetic batches."""
from .checkpoint import (CheckpointError, latest_step, restore_checkpoint,
                         restore_flat, save_checkpoint)
from .data import synthetic_batch
