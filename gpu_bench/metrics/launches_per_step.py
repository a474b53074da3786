"""launches_per_step: the kernels launched under the window's Solver steps
(the dclx.solver.step spans that took a batch) over the number of those
steps. The Solver's layer (train/solver.py)."""

from gpu_bench.harness.program_trace import Innermost, for_context


def read(name, ctx):
    pt = for_context(ctx)
    steps = [] if pt is None or not pt.launches_known() else pt.steps()
    if not steps:
        return None
    inside = Innermost(steps)
    launched = sum(1 for k in pt.kernels if k[3] is not None and inside(k[3]))
    return launched / len(steps)
