"""The port's models (counterpart of dcl_net_tpu/models): the names of its
__init__. Importing it registers DCL_Net and Refiner in registry.MODELS."""

from dcl_net_tpu_torch.models.blocks import (  # noqa: F401
    MaskedBatchNorm,
    SparseConvBlock,
    PointMLP,
)
from dcl_net_tpu_torch.models.backbone import SparseBackbone, MultiScalePointFeatures  # noqa: F401
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses, get_cano_label  # noqa: F401
from dcl_net_tpu_torch.models.refiner import Refiner, refiner_losses  # noqa: F401
