"""serve_rows_padded_pct: padding rows over the rows BundleServer ran in
the window. The rows run are the batch sizes that its dclx.serve.run.b<B>
spans name, where the server picks the artifact of each chunk (the poly
artifact runs the chunk's own rows: dclx.serve.run.poly); the real rows are
the frames' sizes. Serving layer (serving.py BundleServer)."""

from gpu_bench.harness.program_trace import for_context

RUN = "dclx.serve.run."


def read(name, ctx):
    pt = for_context(ctx)
    real = sum(ctx.result.frame_sizes)
    if pt is None or not real:
        return None
    names = [n[len(RUN):] for n, s, _ in pt.program_spans
             if n.startswith(RUN) and pt.trace.t0 <= s <= pt.trace.t1]
    if not names:
        return None
    if "poly" in names:  # a bundle with no fixed artifact: nothing is padded
        return 0.0
    run = sum(int(n[1:]) for n in names)
    return 100.0 * (run - real) / run
