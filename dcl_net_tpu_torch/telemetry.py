"""Named host spans at the port's layer boundaries, for torch.profiler.

    with span("solver.step"):
        ...

While a torch.profiler is on, span(name) records the host interval
"dclx." + name as an operator event, on the profiler's clock, which CUPTI's
records of the device's kernels share: a reduction of the trace can put
each kernel, by the host time of its launch, and each idle gap of the
device under the span that was open on the host (gpu_bench/harness/
program_trace.py does). While no profiler is on, span returns one shared
no-op after a single check; it is a no-op too while torch.export traces
the program (torch.compiler.is_compiling), so no artifact holds a span.

The spans are recorded with the operator scope of torch's RecordFunction
(torch._C._profiler._RecordFunctionFast), not the user-annotation scope of
torch.profiler.record_function: the profiler copies every user annotation
onto the device's timeline, as an event that spans its kernels and the
gaps between them, and the spans are kept off it, so that the device's
events in a trace are its work alone. The program writes nothing: the
profiler that the caller started holds the spans, and the caller writes
them (Solver's profile_dir, the benchmark's traced run).

The names, and the layer each one bounds, are listed in PERF.md (§3).
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "dclx."

_profiler_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context manager: the host span PREFIX + name while a profiler is
    on and nothing traces the program, else the shared no-op."""
    if not _profiler_enabled() or torch.compiler.is_compiling():
        return _NOOP
    return _RecordFunctionFast(PREFIX + name)
