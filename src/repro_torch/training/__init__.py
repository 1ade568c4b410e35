from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, apply_updates, init_state
from repro_torch.training.train_loop import (TrainConfig, TrainLoop,
                                             init_opt_state, loss_and_grads,
                                             make_train_step)

__all__ = [
    "CheckpointManager", "DataConfig", "SyntheticLM", "AdamWConfig",
    "apply_updates", "init_state", "TrainConfig", "TrainLoop",
    "init_opt_state", "loss_and_grads", "make_train_step",
]
