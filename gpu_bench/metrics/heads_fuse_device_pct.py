"""heads_fuse_device_pct: the share of the window's kernel time that was
launched under the port's dclx.model.heads (the disengage heads) and
dclx.model.fuse spans (attention, confidence, neck, pose heads and the
rotation's projection), over all the window's kernel time. Whole step
(models/dcl_net.py and below)."""

from gpu_bench.harness.program_trace import for_context


def read(name, ctx):
    pt = for_context(ctx)
    if pt is None:
        return None
    return pt.kernel_pct_under(("dclx.model.heads", "dclx.model.fuse"))
