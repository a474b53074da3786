"""serve_pad_pct: padding rows over the rows the serving artifacts ran,
from each frame's size and the bundle's fixed batch sizes
(BundleServer's policy: the smallest artifact that holds the frame).
Serving layer (serving.py::BundleServer)."""

from gpu_bench.harness.traffic import padded_rows


def read(name, ctx):
    sizes = ctx.result.frame_sizes
    if not sizes:
        return None
    run = padded_rows(sizes, ctx.loop.server_fixed_sizes)
    return 100.0 * (run - sum(sizes)) / run
