"""serve_p50_ms: the median of the window's frame latencies, from each
frame's due time to its poses on the host. Serving layer."""

import statistics


def read(name, ctx):
    lat = ctx.result.latencies_s
    return statistics.median(lat) * 1e3 if lat else None
