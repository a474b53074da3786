"""The evaluators' one-deep dispatch pipelining, as the JAX Evaluator does
it (dcl_net_tpu/eval/evaluator.py:212-290): batch i + 1 is dispatched
before batch i's [B]-sized results are fetched and scored, and the last
batch is scored after the loop.

The port's Evaluator and Stage2Evaluator, pipelined and in strict order
(each batch's results fetched as it is dispatched, the reference that
chip_smoke.py phase 17(d) also runs on the card), on the same numpy
batches and bridged weights as the JAX evaluators: the same summary. A
counting _run and _score_batch show the order. Small shapes: 16^3 grid, 128 points, three
batches of 4 with a lost row, a pad row and overflowing samples
(tests/test_torch_eval.py's).

The dispatch must not wait for the card: on a CUDA device the eval path's
rotation projection is geometry/rotation.py::nearest_rotation, which
queues no host sync (torch.linalg.svd reads its flags back). It is held
here to the SVD projection in f64 and, with the Newton-Schulz polish, to
the JAX ortho9d_to_matrix in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.eval.evaluator import Evaluator as JaxEvaluator
from dcl_net_tpu.geometry import rotation as jrot
from dcl_net_tpu.eval.evaluator import Stage2Evaluator as JaxStage2Evaluator
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu_torch.data.schema import make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.eval.evaluator import Evaluator, Stage2Evaluator
from dcl_net_tpu_torch.geometry.rotation import nearest_rotation
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.weights import load_jax_variables
from tests.test_torch_eval import DS_KW, KW, N, N_CLASSES, _batches
from tests.test_torch_stage2 import ITERATIONS, _port_refiner, _refiner_variables

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticPoseDataset(**DS_KW)
    batches = _batches(ds) + [make_batch([ds[i] for i in range(7, 11)]).to_dict()]
    bank = ds.template_bank()
    model_points = np.stack([ds.model_points(c, 64) for c in range(N_CLASSES)])
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, **KW)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda k, b: jmodel.init(k, b, train=False))(
            jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, batches[0])))
    jrefiner, rvars = _refiner_variables(seed=4)
    return dict(batches=batches, bank=bank, model_points=model_points, jmodel=jmodel,
                variables=variables, jrefiner=jrefiner, rvars=rvars)


def _port(s, stage: str, strict: bool = False, **kw):
    """The port's evaluator of `stage`; strict: each batch's results are
    fetched as it is dispatched, so nothing of batch i + 1 is queued before
    batch i is done."""
    model = load_jax_variables(DCLNet(device="cpu", **KW), s["variables"])
    if stage == "stage1":
        ev = Evaluator(model, s["model_points"], template_bank=s["bank"], device="cpu", **kw)
    else:
        ev = Stage2Evaluator(model, _port_refiner(s["rvars"]), s["model_points"],
                             iterations=ITERATIONS, template_bank=s["bank"], device="cpu",
                             **kw)
    if strict:
        dispatch = ev._dispatch

        def fetched_at_once(batch):
            pending = dispatch(batch)
            ev._fetch(pending)
            return pending

        ev._dispatch = fetched_at_once
    return ev


def _jax(s, stage: str):
    if stage == "stage1":
        return JaxEvaluator(s["jmodel"], s["variables"], s["model_points"],
                            template_bank=s["bank"])
    return JaxStage2Evaluator(s["jmodel"], s["variables"], s["jrefiner"], s["rvars"],
                              s["model_points"], iterations=ITERATIONS,
                              template_bank=s["bank"])


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_pipelined_summary_equals_strict_order_and_jax(setup, stage):
    batches = setup["batches"]
    piped = _port(setup, stage).evaluate(iter(batches))
    strict = _port(setup, stage, strict=True).evaluate(iter(batches))
    assert piped == strict  # every key, the per-class lists included
    want = _jax(setup, stage).evaluate(iter(batches))
    assert piped["n_scored"] == want["n_scored"] == 11  # 12 rows - 1 pad row
    assert piped["n_lost"] == 1 and piped["n_overflow"] == want["n_overflow"] > 0
    # the two packages' f32 ADD-S distances differ in their last bits (1e-6 m,
    # tests/test_torch_eval.py), which moves a class's AUC by 1e-6 of it
    np.testing.assert_allclose(piped["auc_mean"], want["auc_mean"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(piped["auc_per_class"], want["auc_per_class"],
                               rtol=1e-6, atol=0)
    assert piped["acc_mean"] == want["acc_mean"]


def test_pipelined_add_protocol_with_lost_counts_equals_strict_order(setup):
    """LineMOD's protocol: the ADD and ADD-S rows and the per-class lost
    counts travel in the same one block."""
    kw = dict(protocol="add_0.1d", diameters=[0.01, 0.02, 0.015], sym_class_ids=[1],
              count_lost=True)
    batches = setup["batches"]
    piped = _port(setup, "stage1", **kw).evaluate(iter(batches))
    strict = _port(setup, "stage1", strict=True, **kw).evaluate(iter(batches))
    assert piped == strict and piped["n_lost"] == 1


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_batch_i_plus_1_is_dispatched_before_batch_i_is_scored(setup, stage):
    ev = _port(setup, stage)
    events = []
    run, score = ev._run, ev._score_batch

    def counted_run(batch):
        events.append("run")
        return run(batch)

    def counted_score(*args):
        events.append("score")
        return score(*args)

    ev._run, ev._score_batch = counted_run, counted_score
    res = ev.evaluate(iter(setup["batches"]))
    # one deep: the last batch is consumed after the loop
    assert events == ["run", "run", "score", "run", "score", "score"]
    assert res["n_scored"] == 11


def _svd_projection(m):
    u, _, vh = torch.linalg.svd(m)
    det = torch.linalg.det(u @ vh)
    return (u * torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)[:, None]) @ vh


@pytest.mark.parametrize("case", ["random", "near-rotation", "reflection", "rank-2"])
def test_nearest_rotation_is_the_svd_projection(case):
    rng = np.random.RandomState(["random", "near-rotation", "reflection", "rank-2"].index(case))
    q, _ = np.linalg.qr(rng.randn(64, 3, 3))
    m = {"random": rng.randn(64, 3, 3),
         "near-rotation": q + 1e-4 * rng.randn(64, 3, 3),  # a trained head's M
         "reflection": q @ np.diag([1.0, 0.5, -0.2]),  # det < 0: the det fix
         "rank-2": q @ np.diag([1.0, 1.0, 1e-9]) @ np.swapaxes(q, 1, 2)}[case]
    m = torch.from_numpy(m)
    got = nearest_rotation(m)
    # the same projection as LAPACK's SVD, to f64 round-off
    np.testing.assert_allclose(got.numpy(), _svd_projection(m).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, rtol=0, atol=1e-12)


def test_polished_projection_matches_jax_ortho9d():
    """nearest_rotation, cast to f32 and polished by the two Newton-Schulz
    steps as ortho9d_to_matrix does on the card, against the JAX function."""
    from dcl_net_tpu_torch.geometry.rotation import normalize_vector

    raw = np.random.RandomState(2).randn(16, 9).astype(np.float32)
    cols = [normalize_vector(torch.from_numpy(raw[:, i:i + 3])) for i in (0, 3, 6)]
    r = nearest_rotation(torch.stack(cols, -1))
    assert r.dtype == torch.float32
    eye = torch.eye(3)
    for _ in range(2):
        r = 0.5 * (r @ (3.0 * eye - r.transpose(-1, -2) @ r))
    want = jrot.ortho9d_to_matrix(*(jnp.asarray(raw[:, i:i + 3]) for i in (0, 3, 6)))
    # JAX polishes an f32 SVD, the port its f64 projection: as
    # tests/test_torch_model.py holds the SVD path, 2e-6
    np.testing.assert_allclose(r.numpy(), np.asarray(want), rtol=0, atol=2e-6)
