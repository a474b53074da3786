"""backbone_device_pct: the share of the window's kernel time that was
launched under the port's dclx.model.backbone spans (the sparse conv
pyramid of both branches: convolutions, folded BN, masks, pools), over all
the window's kernel time. Backbone layer (models/backbone.py,
models/blocks.py, ops/sparse_conv.py)."""

from gpu_bench.harness.program_trace import for_context


def read(name, ctx):
    pt = for_context(ctx)
    return None if pt is None else pt.kernel_pct_under(("dclx.model.backbone",))
