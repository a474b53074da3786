"""backbone_active_pct.eval (gpu_bench/metrics/backbone_active_pct.py) on
hand-built traces: the share of the backbone's kernel time launched under
dclx.model.backbone.active; 0 where the rulebook ran and the active span
launched nothing; None without a trace, and for a program that has no
active-site path (no rulebook span), as the backbone's dense path gives."""

import importlib.util

import pytest

from gpu_bench.harness import program_trace as pt_mod
from gpu_bench.harness.program_trace import ProgramTrace
from gpu_bench.harness.spec import reader_path
from gpu_bench.harness.trace import Trace

NAME = "backbone_active_pct.eval"


def reader():
    path = reader_path(NAME)
    spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    def __init__(self, trace):
        self.trace = trace


def _read(spans, kernels):
    """The reader on a window [0, 10] s holding the program's spans and
    kernels (name, start, end, launch)."""
    tr = Trace(0.0, 10.0)
    tr.device = [("kernel", n, s, e) for n, s, e, _ in kernels]
    tr.spans = [("bench.window", 0.0, 10.0)]
    pt_mod._BUILT.clear()
    pt_mod._BUILT[id(tr)] = ProgramTrace(tr, spans, kernels)
    try:
        return reader()(NAME, Ctx(tr))
    finally:
        pt_mod._BUILT.clear()


ENCODE = [("dclx.model.voxelize", 0.5, 0.9), ("dclx.model.backbone", 1.0, 4.0),
          ("dclx.model.point_feats", 4.0, 5.0)]
KERNELS = [("voxelize_tiles", 1.0, 1.5, 0.6),      # K1, outside the backbone
           ("max_pool3d", 1.5, 2.0, 1.2),          # the rulebook's masks
           ("gemm", 2.0, 3.5, 2.5),                 # a conv on rows
           ("index_copy", 3.5, 4.0, 3.5),           # the scatter to a level
           ("compact_count", 6.0, 6.5, 4.5)]        # K2, in point_feats


def test_the_share_under_the_active_span():
    spans = ENCODE + [("dclx.model.backbone.rulebook", 1.1, 2.2),
                      ("dclx.model.backbone.active", 2.2, 3.9)]
    # the backbone launched 0.5 + 1.5 + 0.5 s, the active span 2.0 of them
    assert _read(spans, KERNELS) == pytest.approx(100.0 * 2.0 / 2.5)


def test_zero_where_the_rulebook_ran_and_the_active_span_launched_nothing():
    spans = ENCODE + [("dclx.model.backbone.rulebook", 1.1, 1.3)]
    assert _read(spans, KERNELS) == 0.0


def test_none_without_a_trace_or_without_the_path():
    assert reader()(NAME, Ctx(None)) is None
    # the dense path: backbone kernels, no rulebook or active span
    assert _read(ENCODE, KERNELS) is None
    # no kernel launched under the backbone
    spans = ENCODE + [("dclx.model.backbone.rulebook", 1.1, 1.3)]
    assert _read(spans, [KERNELS[0], KERNELS[-1]]) is None
