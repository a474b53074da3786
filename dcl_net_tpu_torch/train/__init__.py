"""The port's training (counterpart of dcl_net_tpu/train): the names of its
__init__."""

from dcl_net_tpu_torch.train.solver import (  # noqa: F401
    TrainState,
    autoclip,
    build_lr_schedule,
    build_optimizer,
    make_train_step,
    Solver,
)
from dcl_net_tpu_torch.train.checkpoints import save_checkpoint, load_checkpoint  # noqa: F401
