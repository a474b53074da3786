"""The port's stage-1 Evaluator, metrics and data copies against the JAX
package's, on the same numpy inputs and bridged weights.

Small shapes: 16^3 grid, 128 points, 3 classes, batches of 4 with one lost
(valid = 0) row and one pad row; capacities small enough that some samples
overflow, so n_overflow is exercised too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dcl_net_tpu.data.schema import make_batch as jax_make_batch
from dcl_net_tpu.data.synthetic import SyntheticPoseDataset as JaxSynthetic
from dcl_net_tpu.eval import metrics as jmetrics
from dcl_net_tpu.eval.evaluator import Evaluator as JaxEvaluator
from dcl_net_tpu.models import DCLNet as JaxDCLNet
from dcl_net_tpu_torch.data.schema import batch_to_torch, make_batch
from dcl_net_tpu_torch.data.synthetic import SyntheticPoseDataset
from dcl_net_tpu_torch.eval import metrics as tmetrics
from dcl_net_tpu_torch.eval.evaluator import Evaluator
from dcl_net_tpu_torch.models.dcl_net import DCLNet
from dcl_net_tpu_torch.weights import load_jax_variables

torch.set_num_threads(2)

GRID = (16, 16, 16)
UNIT = (0.024, 0.024, 0.024)
N = 128
N_CLASSES = 3
KW = dict(unit_voxel_extent=UNIT, voxel_num_limit=GRID, capacities=(48, 64, 16, 8))
DS_KW = dict(n_objects=N_CLASSES, n_points=N, unit_voxel_extent=UNIT,
             voxel_num_limit=GRID, seed=0)


def _batches(ds):
    """Two host batches of 4: the second has a lost row and a pad row."""
    first = make_batch([ds[i] for i in range(4)]).to_dict()
    lost = dict(ds[5], valid=0.0)
    second = make_batch([ds[4], lost, ds[6]], pad_to=4).to_dict()
    return [first, second]


@pytest.fixture(scope="module")
def evaluators():
    ds = SyntheticPoseDataset(**DS_KW)
    batches = _batches(ds)
    bank = ds.template_bank()
    model_points = np.stack([ds.model_points(c, 64) for c in range(N_CLASSES)])
    jmodel = JaxDCLNet(n_inp=N, n_tmp=N, **KW)
    init = jax.jit(lambda k, b: jmodel.init(k, b, train=False))
    variables = jax.tree.map(
        np.asarray, init(jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, batches[0])))
    tmodel = load_jax_variables(DCLNet(device="cpu", **KW), variables)
    jev = JaxEvaluator(jmodel, variables, model_points, protocol="adds_auc",
                       template_bank=bank)
    tev = Evaluator(tmodel, model_points, template_bank=bank, device="cpu")
    return jev, tev, batches


def test_evaluator_matches_jax(evaluators):
    jev, tev, batches = evaluators
    for batch in batches:
        want = jev._run(jev.variables, jax.tree.map(jnp.asarray, batch))
        got = tev._run(batch_to_torch(batch, "cpu"))
        # per-instance ADD-S (m): f32 through the network and the metric
        np.testing.assert_allclose(got["adds"].numpy(), np.asarray(want["adds"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["overflow"].numpy(),
                                      np.asarray(want["overflow"]))
    want = jev.evaluate(iter(batches))
    got = tev.evaluate(iter(batches))
    assert got["n_scored"] == want["n_scored"] == 7  # 8 rows - 1 pad row
    assert got["n_overflow"] == want["n_overflow"] > 0
    assert got["auc_mean"] == want["auc_mean"]
    assert got["acc_mean"] == want["acc_mean"]
    np.testing.assert_allclose(got["auc_per_class"], want["auc_per_class"],
                               rtol=0, atol=1e-6)


def test_evaluator_without_template_bank_runs_both_branches(evaluators):
    jev, tev, batches = evaluators
    plain = Evaluator(tev.model, tev.model_points.numpy(), device="cpu")
    # without a bank each instance encodes its own template cloud, which
    # for the synthetic data is another draw than the bank's
    res = plain.evaluate(iter(batches))
    assert res["n_scored"] == 7
    assert np.isfinite(res["auc_mean"])


def test_evaluator_refuses_other_protocols_and_no_card(evaluators):
    _, tev, _ = evaluators
    with pytest.raises(ValueError):
        Evaluator(tev.model, tev.model_points.numpy(), protocol="add_0.1d",
                  device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    # the default device is CUDA: without a card it raises, never falls back
    with pytest.raises((RuntimeError, AssertionError)):
        Evaluator(tev.model, tev.model_points.numpy())
    with pytest.raises((RuntimeError, AssertionError)):
        DCLNet(**KW)


def test_metrics_match_jax():
    rng = np.random.RandomState(9)
    d = rng.uniform(0.0, 0.12, 40)
    d[::7] = np.inf
    cls = rng.randint(0, 4, 40)
    assert tmetrics.per_class_auc_acc(d, cls, 4) == jmetrics.per_class_auc_acc(d, cls, 4)
    pts = (rng.rand(3, 50, 3).astype(np.float32) - 0.5) * 0.1
    rots = [np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32) for _ in range(12)]
    r_p, r_g = np.stack(rots[:3]), np.stack(rots[3:6])
    t_p, t_g = (rng.randn(2, 3, 3) * 0.02).astype(np.float32)
    got = tmetrics.add_s_batch(*map(torch.from_numpy, (pts, r_p, t_p, r_g, t_g)))
    want = jmetrics.add_s_batch(*map(jnp.asarray, (pts, r_p, t_p, r_g, t_g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_data_copies_match_jax():
    ours, theirs = SyntheticPoseDataset(**DS_KW), JaxSynthetic(**DS_KW)
    samples = [(ours[i], theirs[i]) for i in range(3)]
    for a, b in samples:
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in ours.template_bank().items():
        np.testing.assert_array_equal(v, theirs.template_bank()[k])
    np.testing.assert_array_equal(ours.model_points(1, 32), theirs.model_points(1, 32))
    lost = dict(samples[1][0], valid=0.0)
    got = make_batch([samples[0][0], lost], pad_to=3).to_dict()
    want = jax_make_batch([samples[0][1], lost], pad_to=3).to_dict()
    for k in ("valid", "pad", "sym_flag"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["inp"]["feats"], want["inp"]["feats"])


def test_update_variables_refreshes_template_cache():
    """update_variables re-encodes the per-class template cache from the new
    weights: the results after it equal a fresh Evaluator's with those
    weights (a stale cache would fuse new observed features with old
    templates), whether the weights come as a state dict or were changed in
    place, as a train step between evaluations changes them."""
    ds = SyntheticPoseDataset(**DS_KW)
    bank = ds.template_bank()
    model_points = np.stack([ds.model_points(c, 64) for c in range(N_CLASSES)])
    batch = batch_to_torch(_batches(ds)[0], "cpu")
    a, b = DCLNet(device="cpu", seed=0, **KW), DCLNet(device="cpu", seed=1, **KW)
    ev = Evaluator(a, model_points, template_bank=bank, device="cpu")
    res_a = ev._run(batch)["adds"]
    ev.update_variables(b.state_dict())
    res_b = ev._run(batch)["adds"]
    fresh = Evaluator(DCLNet(device="cpu", seed=1, **KW), model_points, template_bank=bank,
                      device="cpu")
    res_fresh = fresh._run(batch)["adds"]
    assert torch.equal(res_b, res_fresh)
    assert not torch.allclose(res_a, res_fresh)  # the weights do differ
    # in place: the evaluated model (a, now holding b's weights) takes its
    # first weights back, as a train step would change them, and leaves eval
    # mode
    assert ev.model is a
    with torch.no_grad():
        for p, q in zip(a.parameters(), DCLNet(device="cpu", seed=0, **KW).parameters()):
            p.copy_(q)
    ev.model.train()
    assert not torch.equal(ev._run(batch)["adds"], res_a)  # the stale cache shows
    ev.update_variables()
    assert torch.equal(ev._run(batch)["adds"], res_a)
