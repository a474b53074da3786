"""step_host_ms: the median, over the window's Solver steps (the
dclx.solver.step spans that took a batch), of the step's time outside its
dclx.solver.fetch and dclx.solver.data spans: the host's time to queue one
step (the copy, the forward, loss, backward and optimizer calls), the
waits inside those calls included (the training SVD's sync, a full launch
queue). The Solver's layer (train/solver.py)."""

import statistics

from gpu_bench.harness.program_trace import for_context


def read(name, ctx):
    pt = for_context(ctx)
    steps = [] if pt is None else pt.steps()
    if not steps:
        return None
    return statistics.median(
        pt.self_ms(s, ("dclx.solver.fetch", "dclx.solver.data")) for s in steps)
