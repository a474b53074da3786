"""backbone_conv_pct: the share of the window's kernel time spent in
convolution and pooling kernels (cuDNN's conv3d forward and backward, the
window sums of the pools). Backbone layer (models/backbone.py,
models/blocks.py, ops/sparse_conv.py).

GROUPS is a frozen copy of scripts/profile_torch_stage1.py's kernel-name
groups (first match wins), with the names of cuDNN's backward kernels
(dgrad, wgrad) added to the convolution group."""

GROUPS = (
    ("K1 voxelize", ("voxelize_tiles", "voxelize_rounds")),
    ("K2 compact", ("compact_count", "compact_write")),
    ("K3 interp", ("three_nn_rows",)),
    ("conv3d (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "winograd")),
    ("pooling", ("pool",)),
    ("matmul", ("gemm", "gemv", "cutlass")),
    ("svd/linalg", ("svd", "gesvd", "batched", "lu_", "getrf", "syevj", "gesvdj")),
    ("sort/gather", ("sort", "gather", "index", "scatter", "radix")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "fill", "cat")),
)


def group_of(kernel: str) -> str:
    low = kernel.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def read(name, ctx):
    if ctx.trace is None:
        return None
    times = ctx.trace.kernel_time_by_name()
    total = sum(times.values())
    if total <= 0:
        return None
    backbone = sum(t for k, t in times.items()
                   if group_of(k) in ("conv3d (cuDNN)", "pooling"))
    return 100.0 * backbone / total
