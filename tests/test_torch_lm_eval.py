"""The port's LineMOD scoring against the JAX package's: ADD on the device
(add_batch), the success rate at 0.1 x diameter with and without lost
detections in the denominator (success_at_diameter), and the evaluator's
row scoring under the three lost-row rules (YCB-V: a lost row scores inf;
LineMOD: it is skipped; Occlusion-LineMOD: it counts in its class's
denominator), with pad rows, lost rows, rows flagged symmetric and rows of
a symmetric class, each followed by the protocol's report.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from dcl_net_tpu.eval import metrics as jmetrics
from dcl_net_tpu.eval.evaluator import Evaluator as JaxEvaluator
from dcl_net_tpu_torch.eval import metrics
from dcl_net_tpu_torch.eval.evaluator import Evaluator

N_CLS = 5
SYM_CLASSES = [3]
DIAMETERS = [0.008, 0.012, 0.02, 0.01, 0.015]


def pose_batch(seed, b=16, p=300):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, p, 3) * 0.05).astype(np.float32)
    rot = Rotation.random(2 * b, random_state=rng).as_matrix().astype(np.float32)
    trans = (rng.randn(2, b, 3) * 0.1 + [0, 0, 0.9]).astype(np.float32)
    return pts, rot[:b], trans[0], rot[b:], trans[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_add_batch_matches_jax(seed):
    args = pose_batch(seed)
    want = np.asarray(jmetrics.add_batch(*args))
    got = metrics.add_batch(*map(torch.from_numpy, args)).numpy()
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # identical poses: 0; the ADD-S of the same poses is no larger
    same = metrics.add_batch(*map(torch.from_numpy, args[:3] + args[1:3])).numpy()
    np.testing.assert_array_equal(same, 0)
    adds = metrics.add_s_batch(*map(torch.from_numpy, args)).numpy()
    assert (adds <= got + 1e-6).all()


@pytest.mark.parametrize("lost", [None, [0, 2, 0, 1, 5]])
def test_success_at_diameter_matches_jax(lost):
    rng = np.random.RandomState(7)
    d = rng.rand(200) * 0.03
    c = rng.randint(0, N_CLS - 1, 200)  # class 4 scores nothing: rate 0, or 0 of its lost
    got = metrics.success_at_diameter(d, c, DIAMETERS, num_lost_per_class=lost)
    want = jmetrics.success_at_diameter(d, c, DIAMETERS, num_lost_per_class=lost)
    assert got == want
    assert got["success_per_class"][4] == 0.0
    assert got["count_per_class"][4] == (0 if lost is None else 5)
    n = [int((c == k).sum()) + (lost[k] if lost else 0) for k in range(N_CLS)]
    assert got["count_per_class"] == n
    assert got["success_mean"] == sum(int((d[c == k] < DIAMETERS[k]).sum())
                                      for k in range(N_CLS)) / sum(n)


def score_arrays(seed, b=48):
    """A batch's distances and flags: 6 pad rows at the end, 8 lost rows,
    rows flagged symmetric, and rows of the symmetric class."""
    rng = np.random.RandomState(seed)
    adds = (rng.rand(b) * 0.02).astype(np.float32)
    add = adds + (rng.rand(b) * 0.01).astype(np.float32)
    cls = rng.randint(0, N_CLS, b).astype(np.int64)
    valid = np.ones(b, np.float32)
    valid[rng.choice(b - 6, 8, replace=False)] = 0
    pad = np.zeros(b, np.float32)
    pad[-6:] = 1
    valid[-6:] = 0
    sym = (rng.rand(b) < 0.2).astype(np.float32)
    sym[valid == 0] = -1  # what an invalid reader row carries
    return adds, add, valid, cls, sym, pad


RULES = {  # (protocol, count_lost)
    "ycbv_lost_is_inf": ("adds_auc", False),
    "lm_lost_is_skipped": ("add_0.1d", False),
    "lmo_lost_is_counted": ("add_0.1d", True),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_score_batch_matches_jax(rule):
    protocol, count_lost = RULES[rule]
    model_points = np.zeros((N_CLS, 4, 3), np.float32)
    kw = dict(protocol=protocol, sym_class_ids=SYM_CLASSES, count_lost=count_lost,
              diameters=DIAMETERS)
    port = Evaluator(torch.nn.Identity(), model_points, device="cpu", **kw)
    ref = JaxEvaluator(None, {}, model_points, **kw)
    seen = {}
    for name, ev in (("port", port), ("jax", ref)):
        distances, class_ids, lost_per_class = [], [], {}
        for seed in (0, 1):
            adds, add, valid, cls, sym, pad = score_arrays(seed)
            if name == "port":
                ev._score_batch(adds, add, valid, cls, sym, pad,
                                distances, class_ids, lost_per_class)
            else:
                ev._score_batch(adds, add, valid, cls, sym,
                                distances, class_ids, lost_per_class, pad=pad)
        seen[name] = (distances, class_ids, lost_per_class,
                      ev.summarize(distances, class_ids, lost_per_class))
    assert seen["port"] == seen["jax"]
    distances, class_ids, lost_per_class, report = seen["port"]
    n_lost = 16  # 8 lost rows in each of the two batches
    real = 2 * (48 - 6)
    if rule == "ycbv_lost_is_inf":
        assert len(distances) == real and np.isinf(distances).sum() == n_lost
        assert set(report) == {"auc_per_class", "acc_per_class", "auc_mean", "acc_mean"}
    elif rule == "lm_lost_is_skipped":
        assert len(distances) == real - n_lost and not lost_per_class
        assert sum(report["count_per_class"]) == real - n_lost
    else:
        assert len(distances) == real - n_lost and sum(lost_per_class.values()) == n_lost
        assert sum(report["count_per_class"]) == real
    if protocol == "add_0.1d":  # ADD-S for a flagged row or the symmetric class, else ADD
        adds, add, valid, cls, sym, pad = score_arrays(0)
        scored = (valid > 0) & (pad == 0)
        use_adds = (sym > 0) | np.isin(cls, SYM_CLASSES)
        assert use_adds[scored].any() and (~use_adds[scored]).any()
        want = np.where(use_adds, adds, add)[scored]
        assert distances[:int(scored.sum())] == [float(x) for x in want]


def test_unknown_protocol_and_missing_diameters_raise():
    pts = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(ValueError, match="protocol"):
        Evaluator(torch.nn.Identity(), pts, protocol="add_auc", device="cpu")
    with pytest.raises(ValueError, match="diameters"):
        Evaluator(torch.nn.Identity(), pts, protocol="add_0.1d", device="cpu")
