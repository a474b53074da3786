"""DCL-Net in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``dcl_net_tpu``, which stays the reference: the
modules mirror its paths and names, keep its channel-last layouts at public
functions, and hold f32 semantics. The kernels of stage-1 inference
(voxelize, compaction, 3-NN interpolation, and the fused compaction ->
interpolation of interp_mode "pallas_fused") and of its training (the
interpolation's and the compaction's backwards) live in ``csrc/`` and are
built with nvcc at first use; a CPU tensor takes each kernel's plain version.
Stage 2 (the refiner) is plain PyTorch on top of a stage-1 model. Inference
and training also run in bf16 (model.compute_dtype: bfloat16) through bf16
variants of the kernels. The forward kernels are torch.library custom ops
(ops/library.py), so that serving.py can export the eval forward, with its
weights and template cache, as torch.export artifacts; the voxelize op has
an autograd formula for its features (the JAX package's VJP, in stock
torch). Data parallelism runs over torch.distributed (parallel/mesh.py).

The package exports the JAX package's top-level names: Config, and the
registries (registry.py) in which the models (DCL_Net, Refiner) and the
datasets (synthetic, ycbv_train, ycbv_test, linemod, lmo) register when
their modules are imported; tools/common.py::build_model resolves
cfg.model.name there. Importing the package loads no CUDA and builds no
kernel. On an H100, scripts/train_ddp_multi_gpu.py holds data-parallel
training over NCCL on 2 and 4 cards to one process, and
scripts/torch_synthetic_convergence.py trains stage 1 and the refiner from
scratch on synthetic data and scores them on held-out rows.
"""

import torch


def strict_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions, and keep the
    reductions of bf16 matmuls in f32.

    The port runs f32 and holds it to the JAX reference's f32 results. cuDNN
    runs f32 convolutions in TF32 by default (about three decimal digits),
    which would break that parity for the 64^3 backbone, so every entry
    point calls this before it runs. A bf16 model (model.compute_dtype:
    bfloat16) multiplies bf16 operands with f32 sums, as the JAX package's
    bf16 does; cuBLAS may otherwise add split-K partial sums in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


from dcl_net_tpu_torch.config import Config  # noqa: E402,F401
from dcl_net_tpu_torch.registry import Registry, MODELS, DATASETS  # noqa: E402,F401
