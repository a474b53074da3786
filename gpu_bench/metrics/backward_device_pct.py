"""backward_device_pct: the share of the window's kernel time that was
launched while the port's dclx.train.backward span was open (the autograd
engine's kernels, from its own thread: put there by time), over all the
window's kernel time. Whole step (models/dcl_net.py and below)."""

from gpu_bench.harness.program_trace import for_context


def read(name, ctx):
    pt = for_context(ctx)
    return None if pt is None else pt.kernel_pct_under(("dclx.train.backward",))
