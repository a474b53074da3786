"""serve_dispatch_ms: the median, over the window's frames, of the port's
dclx.serve.request span: the host's time inside BundleServer for one frame
(the copy in, the padding, the artifacts' calls, the outputs' cut).
Serving layer (serving.py BundleServer)."""

import statistics

from gpu_bench.harness.program_trace import for_context


def read(name, ctx):
    pt = for_context(ctx)
    spans = [] if pt is None else pt.spans("dclx.serve.request")
    if not spans:
        return None
    return statistics.median((e - s) * 1e3 for _, s, e in spans)
