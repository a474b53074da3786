"""backbone_active_pct: the share (%) of the kernel time launched under the
port's dclx.model.backbone spans that was launched under
dclx.model.backbone.active, the eval-mode pyramid's convolutions, pools and
scatters on active sites (models/backbone.py::SparseBackbone.
_forward_active); the rest is its rulebook and any level run densely.
Backbone layer (models/backbone.py, models/blocks.py, ops/sparse_conv.py).

None where the run has no trace, no backbone kernel, or no
dclx.model.backbone.rulebook span: a program without the active-site path
reads nothing, one whose rulebook ran and launched nothing under the active
span reads 0."""

from gpu_bench.harness.program_trace import for_context


def read(name, ctx):
    pt = for_context(ctx)
    if pt is None:
        return None
    backbone = pt.kernel_pct_under(("dclx.model.backbone",))
    if not backbone or not pt.spans("dclx.model.backbone.rulebook"):
        return None
    active = pt.kernel_pct_under(("dclx.model.backbone.active",)) or 0.0
    return 100.0 * active / backbone
