"""The program's own host spans in the traced window: the port's "dclx."
spans (dcl_net_tpu_torch/telemetry.py), and the host time at which each
kernel of the window was launched.

harness/trace.py reduces the run's torch.profiler to the device's
operations and the harness's "bench." spans, and the per-layer readers get
that Trace. The readers of the program's spans call for_context(ctx): it
reads the same profiler again, which the run holds on the stack of the
reader's caller, and keeps

- program_spans: (name, start, end) of every "dclx." span;
- kernels: (name, start, end, launch) of every kernel, `launch` the host
  time of the host's CUDA API call (cudaLaunchKernel, cuLaunchKernel, ...)
  that shares the kernel's correlation id (None where the trace has
  none).

A kernel belongs to the innermost program span open on the host when it
was launched. That is decided by time, not by thread: the autograd engine
launches the backward's kernels from its own thread while train.backward
is open on the caller's. A program that has no such spans (one built
before them) gives no ProgramTrace, and its readers return None.

Everything is in seconds on the profiler's clock, which host events and
CUPTI's device records share.
"""

from __future__ import annotations

import bisect
import heapq
import json
import statistics
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from gpu_bench.harness.trace import Trace, _activity

PROGRAM_PREFIX = "dclx."

Span = Tuple[str, float, float]


class Innermost:
    """The innermost (shortest) of a set of spans that holds a time: the
    spans' bounds cut the line into pieces, each named once."""

    def __init__(self, spans: Iterable[Span]):
        spans = sorted(spans, key=lambda s: s[1])
        self.points = sorted({t for _, s, e in spans for t in (s, e)})
        self.names: List[Optional[str]] = []
        active: List[Tuple[float, float, str]] = []  # (duration, end, name)
        k = 0
        for p in self.points:
            while k < len(spans) and spans[k][1] <= p:
                name, s, e = spans[k]
                heapq.heappush(active, (e - s, e, name))
                k += 1
            while active and active[0][1] <= p:
                heapq.heappop(active)
            self.names.append(active[0][2] if active else None)

    def __call__(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.points, t) - 1
        return self.names[i] if i >= 0 else None


@dataclass
class ProgramTrace:
    trace: Trace
    program_spans: List[Span] = field(default_factory=list)
    kernels: List[Tuple[str, float, float, Optional[float]]] = field(default_factory=list)

    def spans(self, name: str) -> List[Span]:
        """The spans called `name` that lie in the window."""
        t0, t1 = self.trace.t0, self.trace.t1
        return [sp for sp in self.program_spans if sp[0] == name and t0 <= sp[1] <= t1]

    def kernel_time(self) -> float:
        return sum(e - s for _, s, e, _ in self.kernels)

    def launches_known(self) -> bool:
        """Whether any kernel was matched to its launch (a trace without
        the CUDA runtime's calls, as on the CPU, has none)."""
        return any(k[3] is not None for k in self.kernels)

    def kernels_under(self, names: Sequence[str]) -> list:
        """The kernels launched while a span of `names` (or a span inside
        one) was open."""
        inside = Innermost([sp for sp in self.program_spans if sp[0] in names])
        return [k for k in self.kernels if k[3] is not None and inside(k[3]) is not None]

    def kernel_pct_under(self, names: Sequence[str]) -> Optional[float]:
        """The share (%) of all kernel time launched under `names`; None
        where the window holds no such span or no kernel."""
        total = self.kernel_time()
        if total <= 0 or not self.launches_known() or \
                not any(sp[0] in names for sp in self.program_spans):
            return None
        return 100.0 * sum(e - s for _, s, e, _ in self.kernels_under(names)) / total

    def device_time_by_span(self) -> Dict[Optional[str], float]:
        """Kernel time by the innermost program span that held its launch
        (None: launched outside every program span, or unmatched)."""
        innermost = Innermost(self.program_spans)
        out: Dict[Optional[str], float] = {}
        for _, s, e, launch in self.kernels:
            key = None if launch is None else innermost(launch)
            out[key] = out.get(key, 0.0) + (e - s)
        return out

    def _gaps(self, top: int) -> List[Tuple[float, float]]:
        """The device's `top` longest idle gaps (start, end)."""
        busy = self.trace.busy_intervals()
        edges = [self.trace.t0] + [x for iv in busy for x in iv] + [self.trace.t1]
        gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
        return gaps[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device's longest idle gaps, each named by the innermost span,
        of the program or the harness, that holds the gap's middle."""
        innermost = Innermost(self.program_spans + self.trace.spans)
        return [(innermost(0.5 * (s + e)) or "host", e - s) for s, e in self._gaps(top)]

    def gaps_by_next_launch(self, top: int = 10) -> List[Tuple[str, float]]:
        """The same gaps, each named by the innermost span that held the
        launch of the kernel that ended it: a name on the host's clock
        alone, which holds where the device's timestamps stand off the
        host's."""
        innermost = Innermost(self.program_spans + self.trace.spans)
        starts = sorted((s, launch) for _, s, _, launch in self.kernels if launch is not None)
        out = []
        for s, e in self._gaps(top):
            i = bisect.bisect_left(starts, (e,))
            name = innermost(starts[i][1]) if i < len(starts) else None
            out.append((name or "host", e - s))
        return out

    def steps(self, unit: str = "dclx.solver.step", holds: str = "dclx.solver.h2d"
              ) -> List[Span]:
        """The window's spans `unit` that hold a span `holds`: the Solver's
        steps that took a batch (the last solver.step of an epoch only
        finds the loader exhausted)."""
        inner = sorted(sp[1] for sp in self.spans(holds))
        return [sp for sp in self.spans(unit)
                if bisect.bisect_left(inner, sp[1]) < bisect.bisect_right(inner, sp[2])]

    def self_ms(self, unit: Span, children: Sequence[str]) -> float:
        """unit's duration less that of its spans named in `children`, ms."""
        _, s, e = unit
        inner = sum(ce - cs for n, cs, ce in self.program_spans
                    if n in children and s <= cs and ce <= e)
        return (e - s - inner) * 1e3

    def host_ms_by_span(self) -> Dict[str, List[float]]:
        """Per span name in the window: [count, median ms, total ms]."""
        durations: Dict[str, List[float]] = {}
        for n, s, e in self.program_spans:
            if self.trace.t0 <= s <= self.trace.t1:
                durations.setdefault(n, []).append((e - s) * 1e3)
        return {n: [len(d), statistics.median(d), sum(d)] for n, d in durations.items()}

    def summary(self) -> Dict[str, object]:
        """What the per-layer metrics do not print: how much kernel time the
        program spans hold, whether every launch precedes its kernel, device
        time by span, idle gaps by span, and each kernel's launches a step."""
        total = self.kernel_time()
        by_span = sorted(self.device_time_by_span().items(), key=lambda kv: -kv[1])
        lead = sorted(k[1] - k[3] for k in self.kernels if k[3] is not None)
        out = {"kernels": len(self.kernels),
               "unmatched": sum(k[3] is None for k in self.kernels),
               "started_before_launch": sum(x < 0 for x in lead),
               "start_after_launch_us": [1e6 * lead[int(q * (len(lead) - 1))]
                                         for q in (0.0, 0.001, 0.01, 0.5)] if lead else [],
               "spans_pct": 100.0 - 100.0 * dict(by_span).get(None, 0.0) / max(total, 1e-30),
               "device_pct_by_span": [[str(n), 100.0 * t / max(total, 1e-30)]
                                      for n, t in by_span[:16]],
               "idle_gaps": [[n, t] for n, t in self.idle_gaps()],
               "idle_gaps_by_next_launch": [n for n, _ in self.gaps_by_next_launch()],
               "host_ms_by_span": self.host_ms_by_span()}
        requests = self.spans("dclx.serve.request")
        if requests:
            held = self.kernels_under(("dclx.serve.request",))
            copies = Innermost([sp for sp in self.trace.spans if sp[0] == "bench.copy_to_host"])
            held += [k for k in self.kernels if k[3] is not None and copies(k[3])]
            out["serve_pct"] = 100.0 * sum(e - s for _, s, e, _ in held) / max(total, 1e-30)
        steps = self.steps()
        if steps:
            inside = Innermost(steps)
            per: Dict[str, int] = {}
            for name, _, _, launch in self.kernels:
                if launch is not None and inside(launch):
                    per[name[:60]] = per.get(name[:60], 0) + 1
            out["steps"] = len(steps)
            out["launches_per_step_by_kernel"] = {
                n: c / len(steps) for n, c in sorted(per.items(), key=lambda kv: -kv[1])}
        return out


def from_profiler(prof, trace: Trace) -> Optional[ProgramTrace]:
    """The program spans and kernel launches of a torch.profiler's events,
    beside harness/trace.py's Trace of the same run; None where the trace
    holds no program span."""
    spans, kernels, launches = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        on_device = str(ev.device_type()).endswith("CUDA")
        if name.startswith(PROGRAM_PREFIX):
            if not on_device:
                spans.append((name, start, end))
        elif _activity(ev) == "kernel":
            kernels.append((name, start, end, ev.correlation_id()))
        elif not on_device and name.startswith("cu") and "::" not in name:
            launches[ev.correlation_id()] = start  # a host CUDA API call
    if not spans:
        return None
    return ProgramTrace(trace, spans, [(n, s, e, launches.get(c)) for n, s, e, c in kernels])


_BUILT: Dict[int, Optional[ProgramTrace]] = {}


def _profiler_on_stack():
    """The torch.profiler.profile that a caller of this module's caller
    holds in a local (the traced run's), or None."""
    import torch

    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, torch.profiler.profile) and value.profiler is not None:
                return value
        frame = frame.f_back
    return None


def for_context(ctx) -> Optional[ProgramTrace]:
    """The ProgramTrace of a reader's context (built once a run), or None
    where the run was not traced or its program has no spans. The first
    build prints its summary to stderr as one JSON line."""
    if ctx.trace is None:
        return None
    key = id(ctx.trace)
    if key not in _BUILT:
        prof = _profiler_on_stack()
        pt = None if prof is None else from_profiler(prof, ctx.trace)
        _BUILT.clear()
        _BUILT[key] = pt
        if pt is not None:
            print("program_spans " + json.dumps(pt.summary()), file=sys.stderr, flush=True)
    return _BUILT[key]
