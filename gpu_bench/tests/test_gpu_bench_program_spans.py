"""harness/program_trace.py and the readers of the program's spans, on
hand-built traces and on a real CPU torch.profiler trace of dclx. spans.

A kernel goes to the innermost program span that held its launch, by time
across threads; kernels launched outside every program span stay
unattributed; idle gaps take the innermost span of either kind; the
harness's own reduction (harness/trace.py) and its readers see nothing of
the program's spans; each new reader computes its number."""

import importlib.util

import pytest
import torch

from dcl_net_tpu_torch.telemetry import span
from gpu_bench.harness import program_trace as pt_mod
from gpu_bench.harness import trace as trace_mod
from gpu_bench.harness.program_trace import Innermost, ProgramTrace
from gpu_bench.harness.spec import reader_path
from gpu_bench.harness.trace import Trace
from gpu_bench.harness.traffic import padded_rows

OLD_READERS = ("device_idle_pct.eval", "backbone_conv_pct.eval", "kernels_roofline_pct.eval",
               "mfu_pct.eval", "serve_pad_pct", "serve_p50_ms", "serve_device_ms_per_frame")


def reader(name):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    def __init__(self, trace, frame_sizes=(), fixed=(1, 16)):
        self.trace = trace
        self.work = {"flops": 1e12, "kernel_bound_s": 0.5}
        self.peak_flops = 67e12
        self.result = type("R", (), {"frame_sizes": list(frame_sizes), "units": 3,
                                     "latencies_s": [0.01, 0.02, 0.03]})()
        self.loop = type("L", (), {"server_fixed_sizes": list(fixed)})()


def _trace():
    """A window [0, 10] s: kernels at 1-2 (conv), 3-4 and 6-6.5, harness
    spans bench.window and bench.train_epoch around all of it."""
    tr = Trace(0.0, 10.0)
    tr.device = [("kernel", "sm80_xmma_fprop_conv", 1.0, 2.0),
                 ("kernel", "elementwise_kernel", 3.0, 4.0),
                 ("kernel", "compact_count", 6.0, 6.5),
                 ("gpu_memcpy", "Memcpy HtoD", 8.0, 8.2)]
    tr.spans = [("bench.window", 0.0, 10.0), ("bench.train_epoch", 0.1, 9.9)]
    return tr


def _program(tr):
    spans = [("dclx.solver.step", 0.5, 5.5), ("dclx.solver.h2d", 0.55, 0.6),
             ("dclx.train.forward", 0.6, 1.5), ("dclx.model.backbone", 0.7, 1.2),
             ("dclx.train.backward", 1.5, 4.5), ("dclx.solver.fetch", 4.5, 5.4),
             ("dclx.solver.step", 5.5, 9.0), ("dclx.solver.data", 5.5, 5.6)]
    kernels = [("sm80_xmma_fprop_conv", 1.0, 2.0, 0.8),   # backbone, inside forward
               ("elementwise_kernel", 3.0, 4.0, 2.0),     # backward (its own thread)
               ("compact_count", 6.0, 6.5, 9.5)]          # after every program span
    return ProgramTrace(tr, spans, kernels)


def test_innermost_takes_the_shortest_span_holding_the_time():
    inner = Innermost([("a", 0.0, 10.0), ("b", 2.0, 4.0), ("c", 3.0, 8.0)])
    assert [inner(t) for t in (-1.0, 1.0, 2.5, 3.5, 5.0, 9.0, 10.0)] == [
        None, "a", "b", "b", "c", "a", None]


def test_kernels_go_to_the_innermost_program_span_of_their_launch():
    pt = _program(_trace())
    by_span = pt.device_time_by_span()
    assert by_span == {"dclx.model.backbone": 1.0, "dclx.train.backward": 1.0, None: 0.5}
    assert pt.kernel_pct_under(("dclx.train.forward",)) == pytest.approx(40.0)
    assert pt.kernel_pct_under(("dclx.model.heads",)) is None


def test_idle_gaps_prefer_the_program_span():
    tr = _trace()
    gaps = [(n, round(t, 6)) for n, t in _program(tr).idle_gaps()]
    # by their middles: 5.0 in solver.fetch, 9.1 after every program span,
    # 7.25 in the second solver.step, 0.5 where the first begins, 2.5 in
    # train.backward
    assert gaps == [("dclx.solver.fetch", 2.0), ("bench.train_epoch", 1.8),
                    ("dclx.solver.step", 1.5), ("dclx.solver.step", 1.0),
                    ("dclx.train.backward", 1.0)]
    assert tr.idle_gaps()[0] == ("bench.train_epoch", 2.0)
    # by the launch of the kernel that ended each: 6.0 was launched at 9.5,
    # after every program span; 1.0, 3.0 at 0.8 and 2.0; nothing ends the last
    assert [n for n, _ in _program(tr).gaps_by_next_launch()] == [
        "bench.train_epoch", "host", "host", "dclx.model.backbone", "dclx.train.backward"]


@pytest.mark.card
def test_kernels_of_the_backward_thread_go_to_train_backward_on_the_card(card):
    """On the card: every kernel has its launch, starts after it, and the
    autograd engine's kernels, launched from its own thread, go to the
    train.backward span open on this one; the harness's reduction holds no
    dclx. event."""
    x = torch.randn(1 << 20, device=card, requires_grad=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            with span("train.forward"):
                y = (x * x).sin().sum()
            with span("train.backward"):
                (g,) = torch.autograd.grad(y, x)
            torch.cuda.synchronize()
    tr = trace_mod.from_profiler(prof)
    assert not [n for _, n, _, _ in tr.device if n.startswith("dclx.")]
    pt = pt_mod.from_profiler(prof, tr)
    assert pt.kernels and all(k[3] is not None and k[1] >= k[3] for k in pt.kernels)
    by_span = pt.device_time_by_span()
    assert set(by_span) == {"dclx.train.forward", "dclx.train.backward"}
    names = {e.name(): e.start_thread_id() for e in prof.profiler.kineto_results.events()}
    assert any(n.startswith("autograd::engine") for n in names)


def _window_profile(with_spans: bool):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.window"):
            if with_spans:
                with span("serve.request"):
                    with span("serve.run.b00016"):
                        torch.ones(8).cumsum(0)
            else:
                torch.ones(8).cumsum(0)
    return prof


def test_the_harness_reduction_sees_no_program_span():
    for with_spans in (True, False):
        tr = trace_mod.from_profiler(_window_profile(with_spans))
        assert [n for n, _, _ in tr.spans] == ["bench.window"]
        assert not [n for _, n, _, _ in tr.device if n.startswith("dclx.")]


def test_program_spans_are_read_from_the_profiler_on_the_stack():
    prof = _window_profile(True)
    ctx = Ctx(trace_mod.from_profiler(prof), frame_sizes=[5])
    pt = pt_mod.for_context(ctx)  # prof is a local of this frame
    assert [n for n, _, _ in pt.program_spans] == ["dclx.serve.request",
                                                   "dclx.serve.run.b00016"]
    assert reader("serve_rows_padded_pct")("serve_rows_padded_pct", ctx) == pytest.approx(
        100.0 * 11 / 16)
    assert reader("serve_dispatch_ms")("serve_dispatch_ms", ctx) > 0
    ctx_old = Ctx(trace_mod.from_profiler(_window_profile(False)), frame_sizes=[5])
    for name in ("serve_rows_padded_pct", "serve_dispatch_ms", "step_host_ms.train",
                 "launches_per_step.train", "backbone_device_pct.eval"):
        assert reader(name)(name, ctx_old) is None   # a program without spans


def test_the_old_readers_read_the_same_with_program_spans():
    tr = _trace()
    bare = {n: reader(n)(n, Ctx(tr, frame_sizes=[1, 5, 8])) for n in OLD_READERS}
    pt_mod._BUILT[id(tr)] = _program(tr)
    try:
        spanned = {n: reader(n)(n, Ctx(tr, frame_sizes=[1, 5, 8])) for n in OLD_READERS}
    finally:
        pt_mod._BUILT.clear()
    assert spanned == bare and all(v is not None for v in bare.values())


def _with(pt, frame_sizes=()):
    ctx = Ctx(pt.trace, frame_sizes)
    pt_mod._BUILT.clear()
    pt_mod._BUILT[id(pt.trace)] = pt
    return ctx


def test_device_share_readers():
    tr = _trace()
    pt = _program(tr)
    pt.program_spans += [("dclx.model.heads", 2.8, 3.2), ("dclx.model.fuse", 5.7, 5.9)]
    pt.kernels.append(("gemm", 7.0, 7.5, 5.8))  # launched in fuse
    ctx = _with(pt)
    assert reader("backbone_device_pct.eval")("backbone_device_pct.eval", ctx) == \
        pytest.approx(100.0 / 3.0)
    # heads hold no launch (the backward's kernel was launched at 2.0), fuse 0.5 s
    assert reader("heads_fuse_device_pct.eval")("heads_fuse_device_pct.eval", ctx) == \
        pytest.approx(100.0 * 0.5 / 3.0)
    assert reader("backward_device_pct.train")("backward_device_pct.train", ctx) == \
        pytest.approx(100.0 / 3.0)
    pt_mod._BUILT.clear()


def test_step_readers_count_the_steps_that_took_a_batch():
    tr = _trace()
    pt = _program(tr)
    # a second step with a batch, launching two kernels; the first step of
    # _program launched 2 and the span at 5.5-9.0 holds no solver.h2d
    pt.program_spans += [("dclx.solver.step", 9.55, 9.9), ("dclx.solver.data", 9.55, 9.6),
                         ("dclx.solver.h2d", 9.6, 9.62), ("dclx.solver.fetch", 9.8, 9.85)]
    pt.kernels += [("k", 9.7, 9.75, 9.65), ("k", 9.75, 9.8, 9.66)]
    ctx = _with(pt)
    assert pt.steps() == [("dclx.solver.step", 0.5, 5.5), ("dclx.solver.step", 9.55, 9.9)]
    assert reader("launches_per_step.train")("launches_per_step.train", ctx) == 2.0
    # host time outside fetch and data: 5.0 - 0.9 s and 0.35 - 0.1 s
    assert reader("step_host_ms.train")("step_host_ms.train", ctx) == pytest.approx(
        (4100.0 + 250.0) / 2)
    pt_mod._BUILT.clear()


def test_serve_readers_on_the_harness_traffic():
    """Frames of 1-8 rows, each size once, on artifacts of 1 and 16 rows:
    the spans' rows padded read what serve_pad_pct reads, 68.142 %."""
    sizes = list(range(1, 9)) * 4
    tr = Trace(0.0, 100.0)
    spans = []
    for k, n in enumerate(sizes):
        spans += [("dclx.serve.request", k + 0.1, k + 0.1 + 0.001 * n),
                  (f"dclx.serve.run.b{1 if n == 1 else 16:05d}", k + 0.2, k + 0.3)]
    ctx = _with(ProgramTrace(tr, spans, []), sizes)
    padded = reader("serve_rows_padded_pct")("serve_rows_padded_pct", ctx)
    assert padded == pytest.approx(reader("serve_pad_pct")("serve_pad_pct", ctx))
    assert round(padded, 3) == 68.142
    run = padded_rows(sizes, [1, 16])
    assert padded == pytest.approx(100.0 * (run - sum(sizes)) / run)
    assert reader("serve_dispatch_ms")("serve_dispatch_ms", ctx) == pytest.approx(4.5)
    pt_mod._BUILT.clear()
    poly = [("dclx.serve.request", 0.1, 0.2), ("dclx.serve.run.poly", 0.12, 0.18)]
    ctx = _with(ProgramTrace(tr, poly, []), [3])
    assert reader("serve_rows_padded_pct")("serve_rows_padded_pct", ctx) == 0.0
    pt_mod._BUILT.clear()
