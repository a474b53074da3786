"""The port's ops: the kernels' wrappers and their plain versions, and the
names dcl_net_tpu/ops/__init__.py exports, under the same names.

Importing the package registers the custom ops of the forward kernels
(library.py), through which the wrappers reach them. As in the JAX
package, the functions `voxelize` and `knn` stand in this namespace over
the submodules of those names: reach the modules through
importlib.import_module (or sys.modules). The JAX package's Pallas 3-NN
interpolation, pallas_nn_interpolate, is kernel K3 here:
ops/cuda_interp.py::nn_interpolate."""

from dcl_net_tpu_torch.ops import library  # noqa: F401
from dcl_net_tpu_torch.ops.voxelize import (  # noqa: F401
    voxelize,
    voxelize_dense,
    point_to_voxel_index,
    point_recover,
)
from dcl_net_tpu_torch.ops.sparse_conv import (  # noqa: F401
    dilate_mask,
    sparse_avg_pool,
    sparse_conv_transpose,
    sparse_inverse_conv,
    sparse_max_pool,
    masked_batch_norm_stats,
    dense_to_sparse,
)
from dcl_net_tpu_torch.ops.knn import (  # noqa: F401
    knn,
    three_nn,
    three_interpolate,
    nearest_neighbor_interpolate,
    furthest_point_sample,
    ball_query,
    grouping_operation,
    gather_operation,
)
from dcl_net_tpu_torch.ops.grid_interp import local_grid_interpolate  # noqa: F401
