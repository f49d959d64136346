"""repro_torch.train — AdamW, the train step, the data pipeline and
grid-independent checkpoints (the JAX package's format)."""
from .checkpoint import (CheckpointError, latest_step, restore_checkpoint,
                         restore_flat, save_checkpoint)
from .data import Prefetcher, SyntheticLM, make_batch_specs, synthetic_batch
from .optimizer import (AdamWConfig, adamw_update, global_norm,
                        init_opt_state, lr_schedule)
from .train_step import make_train_step, value_and_grad
