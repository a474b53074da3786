"""The port's evaluation (counterpart of dcl_net_tpu/eval): the names of
its __init__."""

from dcl_net_tpu_torch.eval.metrics import (  # noqa: F401
    voc_ap,
    auc_and_acc,
    per_class_auc_acc,
    add_s_batch,
    add_batch,
    success_at_diameter,
)
from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator  # noqa: F401
