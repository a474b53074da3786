"""The port's data (counterpart of dcl_net_tpu/data): the names of its
__init__, with batch_to_torch for the JAX package's batch_to_jax. The
readers register their datasets in registry.DATASETS when imported:
synthetic here, ycbv_train / ycbv_test in data/ycbv.py, linemod / lmo in
data/linemod.py."""

from dcl_net_tpu_torch.data.schema import PoseBatch, make_batch, batch_to_torch  # noqa: F401
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset  # noqa: F401
