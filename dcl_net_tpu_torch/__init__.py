"""DCL-Net in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``dcl_net_tpu``, which stays the reference: the
modules mirror its paths and names, keep its channel-last layouts at public
functions, and hold f32 semantics. The kernels of stage-1 inference
(voxelize, compaction, 3-NN interpolation, and the fused compaction ->
interpolation of interp_mode "pallas_fused") and of its training (the
interpolation's and the compaction's backwards) live in ``csrc/`` and are
built with nvcc at first use; a CPU tensor takes each kernel's plain version.
Stage 2 (the refiner) is plain PyTorch on top of a stage-1 model.
"""

import torch


def strict_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions.

    The port runs f32 and holds it to the JAX reference's f32 results. cuDNN
    runs f32 convolutions in TF32 by default (about three decimal digits),
    which would break that parity for the 64^3 backbone, so every entry
    point calls this before it runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one."""
    return torch.device("cuda" if device is None else device)


def autotune_convs() -> None:
    """Let cuDNN time its algorithms for each conv shape at first use
    (torch.backends.cudnn.benchmark). Training calls it: for the f32 3D
    weight gradients at the main path's shapes, cuDNN's default choice
    (wgrad2d_grouped_direct_kernel) took 96 % of a step's device time on an
    H100 (scripts/profile_torch_train.py)."""
    torch.backends.cudnn.benchmark = True
