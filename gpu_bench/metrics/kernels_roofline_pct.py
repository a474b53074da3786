"""kernels_roofline_pct: the hand kernels' share of their roofline, the
least time their launches in the window could take (bytes over 3.35 TB/s
or operations over the f32 peak, each launch by its own bound, from its
shapes and these inputs' occupancies: counts/work.py) over the device time
of those kernels in the trace. Kernels layer (ops/cuda_*.py ->
csrc/*.cu: K1-K5 on these paths).

KERNELS are the port's kernel names (csrc/*.cu, csrc/*.cuh), matched as
substrings of the trace's kernel names."""

KERNELS = ("voxelize_tiles", "voxelize_rounds", "compact_count", "compact_write",
           "three_nn_rows", "build_csr", "chunk_counts", "scan_counts", "place_chunk",
           "interp_rows_bwd", "compact_occupied_bwd", "compact_interp_grid_bwd")


def read(name, ctx):
    if ctx.trace is None or not ctx.work:
        return None
    device = sum(t for k, t in ctx.trace.kernel_time_by_name().items()
                 if any(h in k for h in KERNELS))
    if device <= 0:
        return None
    return 100.0 * ctx.work["kernel_bound_s"] / device
