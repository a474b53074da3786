"""The traced window: torch.profiler's device and host events, reduced to
what the per-layer readers and the result's `breakdown` take.

Device time is read from CUPTI's records of kernels, copies and sets
(`device_type` CUDA); the host's record_function spans that the loops put
around each call into a layer name what the host was doing in an idle gap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    """Events of the window [t0, t1] (seconds on the profiler's clock)."""

    t0: float
    t1: float
    device: List[Tuple[str, str, float, float]] = field(default_factory=list)  # (activity, name, start, end)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)        # (name, start, end)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> List[Tuple[str, float, float]]:
        return [(n, s, e) for a, n, s, e in self.device if a == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        iv = sorted((max(s, self.t0), min(e, self.t1)) for _, _, s, e in self.device
                    if e > self.t0 and s < self.t1)
        merged: List[Tuple[float, float]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, s, e in self.kernels():
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest idle gaps of the device, each named by the innermost
        harness span that holds the gap's middle (what the host was doing)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            inside = [(se - ss, n) for n, ss, se in self.spans if ss <= mid <= se]
            out.append((min(inside)[1] if inside else "host", e - s))
        return out


def _activity(ev) -> str:
    """"kernel", "gpu_memcpy", "gpu_memset", "span" (a harness span on the
    host) or "" for anything else. Torch releases differ in what a kineto
    event reports, so this reads only its device type and name."""
    name = ev.name()
    on_device = str(ev.device_type()).endswith("CUDA")
    if name.startswith(SPAN_PREFIX):
        return "" if on_device else "span"
    if not on_device:
        return ""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_profiler(prof, window_span: str = SPAN_PREFIX + "window") -> Trace:
    """The profiler's events inside the host span `window_span` (the
    window's bounds on the profiler's own clock)."""
    events = []
    for ev in prof.profiler.kineto_results.events():
        act = _activity(ev)
        if act:
            start = ev.start_ns() * 1e-9
            events.append((act, ev.name(), start, start + ev.duration_ns() * 1e-9))
    bounds = [(s, e) for a, n, s, e in events if a == "span" and n == window_span]
    if not bounds:
        raise RuntimeError(f"the trace holds no span {window_span}")
    tr = Trace(*bounds[0])
    for act, name, s, e in events:
        if act == "span":
            tr.spans.append((name, s, e))
        else:
            tr.device.append((act, name, s, e))
    return tr


def breakdown(tr: Trace) -> Dict[str, List]:
    """The result's breakdown: the ten device operations that took most time
    (kernels by name, copies and sets by kind) and the ten longest idle
    gaps by what the host was doing."""
    ops: Dict[str, float] = {}
    for act, n, s, e in tr.device:
        key = n if act == "kernel" else act
        ops[key] = ops.get(key, 0.0) + (e - s)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in tr.idle_gaps()]}
