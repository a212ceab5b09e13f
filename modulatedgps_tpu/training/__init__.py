from .loop import (run_adam, run_adam_multistart, make_train_step,
                   TrainState)
from .checkpoint import save_checkpoint, restore_checkpoint
from .scipy_opt import run_scipy

__all__ = ["run_adam", "run_adam_multistart", "make_train_step",
           "TrainState",
           "save_checkpoint", "restore_checkpoint", "run_scipy"]
