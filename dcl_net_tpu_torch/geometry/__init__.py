"""Rotations, rigid transforms and Wigner-D matrices (plain PyTorch);
the names of dcl_net_tpu/geometry/__init__.py."""

from dcl_net_tpu_torch.geometry.rotation import (  # noqa: F401
    normalize_vector,
    cross_product,
    ortho6d_to_matrix,
    ortho9d_to_matrix,
    quaternion_to_matrix,
    matrix_to_quaternion,
    axis_angle_to_matrix,
    euler_to_matrix,
    random_rotation,
)
from dcl_net_tpu_torch.geometry.transform import (  # noqa: F401
    transform_points,
    compose_pose,
    invert_pose,
    l2_distance,
    chamfer_distance,
    pairwise_sq_dist,
)
