"""The port's host spans (dcl_net_tpu_torch/telemetry.py) on the CPU.

Without a profiler span() is one shared no-op and records nothing. Under a
CPU torch.profiler, Evaluator.evaluate over 2 batches, a 2-step
Solver.train_epoch and a BundleServer with 1- and 16-row artifacts each
give the span tree PERF.md lists (names and nesting, by interval), and
every output is torch.equal to the same run without the profiler. An
artifact exported while a profiler is on holds no profiler node. Small
shapes: 16^3 grid, 128 points (tests/test_torch_eval.py's).
"""

import logging
import os

import numpy as np
import pytest
import torch

from dcl_net_tpu_torch import serving, telemetry
from dcl_net_tpu_torch.config import Config
from dcl_net_tpu_torch.data.loader import BatchLoader
from dcl_net_tpu_torch.data.schema import make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.eval.evaluator import Evaluator
from dcl_net_tpu_torch.models.dcl_net import DCLNet, dcl_losses
from dcl_net_tpu_torch.train.solver import Solver

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 128
N_CLASSES = 3
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=(48, 64, 16, 8))
DS_KW = dict(n_objects=N_CLASSES, n_points=N, unit_voxel_extent=UNIT,
             voxel_num_limit=GRID, seed=0)
OPT_CFG = {
    "optimizer": {"type": "Adam", "lr": 0.001, "betas": [0.5, 0.999], "eps": 1e-6},
    "lr_scheduler_cyc": {"max_lr": 0.001, "base_lr": 1e-6, "step_size_up": 3,
                         "step_size_down": 2},
    "clip_percentile": 50,
}

ENCODE = [("model.voxelize", []), ("model.backbone", []), ("model.point_feats", []),
          ("model.heads", [])]
FUSE = ("model.fuse", [])


def _profiled(fn):
    """fn() under a CPU torch.profiler: (its result, the span tree)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name()[len(telemetry.PREFIX):], e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(telemetry.PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return out, _tree(spans)


def _tree(spans):
    """[(name, children)] of the spans nested by interval, in start order."""
    roots, open_ = [], []  # open_: (end, children list) of the enclosing spans
    for name, start, end in spans:
        while open_ and not end <= open_[-1][0]:
            open_.pop()
        node = (name, [])
        (open_[-1][1] if open_ else roots).append(node)
        open_.append((end, node[1]))
    return roots


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    made = []

    class Counting:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(telemetry, "_RecordFunctionFast", Counting)
    assert telemetry.span("a") is telemetry.span("b") is telemetry._NOOP
    with telemetry.span("a"):
        pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with telemetry.span("a"):
            pass
    assert made == ["dclx.a"]


@pytest.fixture(scope="module")
def data():
    ds = SyntheticPoseDataset(**DS_KW)
    batches = [make_batch([ds[i] for i in range(4 * k, 4 * k + 4)]).to_dict()
               for k in range(2)]
    model_points = np.stack([ds.model_points(c, 64) for c in range(N_CLASSES)])
    return dict(ds=ds, batches=batches, bank=ds.template_bank(), model_points=model_points)


def _evaluate(data):
    """Evaluator.evaluate over the 2 batches: (summary, each _run's rows)."""
    ev = Evaluator(DCLNet(device="cpu", seed=3, **KW), data["model_points"],
                   template_bank=data["bank"], device="cpu")
    runs = []
    run = ev._run

    def kept(batch):
        res = run(batch)
        runs.append(res)
        return res

    ev._run = kept
    return ev.evaluate(data["batches"]), runs


def test_evaluator_spans_and_outputs(data):
    (summary, runs), tree = _profiled(lambda: _evaluate(data))
    dispatch = ("eval.dispatch", [("eval.h2d", [])] + ENCODE
                + [FUSE, ("eval.score", []), ("eval.rows", [])])
    fetch = [("eval.fetch", []), ("eval.consume", [])]
    # the template cache's encode, then one deep: dispatch 0, 1, fetch 0, 1
    assert tree == ENCODE + [dispatch, dispatch] + fetch + fetch
    plain_summary, plain_runs = _evaluate(data)
    assert summary == plain_summary
    for a, b in zip(runs, plain_runs, strict=True):
        for k in ("rot_pred", "trans_pred", "adds", "overflow"):
            assert torch.equal(a[k], b[k]), k


class _Writer:
    def __init__(self):
        self.records = []

    def add_scalars(self, tag, values, step):
        self.records.append((tag, step, {k: v for k, v in values.items()
                                         if k not in ("T_data", "T_step")}))


def _train(data):
    """A 2-step Solver epoch at batch 2: (the written metrics, parameters)."""
    writer = _Writer()
    cfg = Config(dict(OPT_CFG, max_epoch=1, per_write=1, per_save=0))
    model = DCLNet(device="cpu", seed=3, **KW)
    loader = BatchLoader(SyntheticPoseDataset(**dict(DS_KW, length=4)), batch_size=2,
                         num_workers=1, seed=1)
    solver = Solver(model, dcl_losses, cfg, loader, device="cpu", writer=writer,
                    logger=logging.getLogger("test_torch_telemetry"))
    solver.train_epoch()
    return writer.records, [p.detach().clone() for p in model.parameters()]


def test_solver_spans_and_outputs(data):
    (records, params), tree = _profiled(lambda: _train(data))
    step = [("solver.data", []), ("solver.h2d", []),
            ("train.forward", ENCODE + ENCODE + [FUSE]), ("train.loss", []),
            ("train.backward", []), ("train.optimizer", [])]
    fetch = ("solver.fetch", [])
    # step 1 reads step 0's metrics; the loader's end is asked in a third
    # solver.step; the last step's metrics are read after the loop
    assert tree == [("solver.step", step), ("solver.step", step + [fetch]),
                    ("solver.step", [("solver.data", [])]), fetch]
    plain_records, plain_params = _train(data)
    assert records == plain_records and len(records) == 2
    for a, b in zip(params, plain_params, strict=True):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def bundle(data, tmp_path_factory):
    """A bundle of 1- and 16-row artifacts, exported under a profiler."""
    model = DCLNet(device="cpu", seed=3, **KW)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        artifacts = serving.export_bundle(model, data["bank"], N, batch_sizes=(1, 16),
                                          include_poly=False)
    path = os.path.join(tmp_path_factory.mktemp("telemetry"), "bundle")
    serving.save_bundle(path, artifacts, model)
    return path


def test_artifact_exported_under_a_profiler_has_no_profiler_node(bundle):
    server = serving.BundleServer(bundle)
    for name in ("b00001", "b00016"):
        targets = [str(n.target) for n in server._fn(name).graph.nodes]
        assert any("dclx" in t for t in targets)  # the kernels' ops are there
        assert not [t for t in targets if "profiler" in t or "record_function" in t]


def test_bundle_server_spans_and_outputs(data, bundle):
    ds = data["ds"]
    rows = make_batch([ds[i % 8] for i in range(17)]).to_dict()
    sizes = (1, 5, 16, 17)

    def serve():
        server = serving.BundleServer(bundle)
        return [server(rows["inp"]["feats"][:n], rows["inp"]["voxel_idx"][:n],
                       rows["labels"]["obj_idx"][:n]) for n in sizes]

    plain = serve()
    outs, tree = _profiled(serve)

    def request(*runs):
        return ("serve.request", [("serve.h2d", [])]
                + [(f"serve.run.{r}", []) for r in runs] + [("serve.gather", [])])

    assert tree == [request("b00001"), request("b00016"), request("b00016"),
                    request("b00016", "b00001")]
    for n, a, b in zip(sizes, outs, plain, strict=True):
        assert a.keys() == b.keys() and a["rot_pred"].shape[0] == n
        for k in a:
            assert torch.equal(a[k], b[k]), (n, k)
