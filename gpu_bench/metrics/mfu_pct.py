"""mfu_pct: the model's FLOPs for the window's inputs over the traced
window's time, against the card's peak for the configuration's compute
type. The FLOPs are the sparse model's (counts/work.py): conv layers over
the (active output, active input neighbour) pairs of these inputs, the
heads' and the fuse's matrix products; training counts the backward as
twice the forward. Whole step (models/dcl_net.py and everything under it)."""


def read(name, ctx):
    if ctx.trace is None or not ctx.work or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.work["flops"] / (ctx.trace.window_s * ctx.peak_flops)
