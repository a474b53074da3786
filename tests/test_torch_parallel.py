"""Data parallelism of the port: 2 gloo ranks on the CPU against one process.

Every case of tests/parallel_ranks.py runs once in 2 ranks started with
torch.multiprocessing (each rank on its block of a global batch of 8 rows
at the 16^3 test size; a file:// rendezvous in a temporary directory) and
once in this process on the whole batch, and the two are compared: the
synced BatchNorm statistics and their backward, one train step on the
two-stage and fused paths, with the template bank, with unequal counts of
valid rows per rank, under model.remat, with a NaN loss on one rank only,
a stage-2 refiner step, and the evaluators
(tests/test_torch_parallel_jax.py holds the ranks' step to the JAX
package's single-device step).

The bounds of a step, as the JAX package holds its multi-host dryrun
(tests/test_multihost.py:82): the losses within rtol 1e-5, the flat
gradient within 5e-3 relative L2 (the port's bound, PERF.md section 2).
The two differ only in the order of float sums: the ranks' blocks are
summed apart and then added.

DistributedDataParallel and the port's step: the step takes its gradient
with torch.autograd.grad, which accumulates nothing into .grad, so DDP's
reducer, which hooks that accumulation, all-reduces nothing and each rank
keeps its own gradient (test_ddp_reducer_does_not_see_autograd_grad). The
port therefore all-reduces the flat gradient itself
(train/solver.py::apply_gradients).
"""

import numpy as np
import pytest
import torch

from tests import parallel_ranks as pr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [rank 0's, rank 1's results], "single": this process's}:
    the ranks run while this process computes."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    batch = pr.global_batch()
    ds = pr.dataset()
    inputs = {**pr.bn_inputs(), "batch": batch,
              "bank": ds.template_bank(), "model_points": pr.model_points(),
              "eval_batches": [batch, pr.global_batch(pr.BATCH)]}
    cases = [c for c in pr.CASES if c != "step_f64"]
    context = pr.start_ranks(tmp, inputs, cases)
    single = pr.single([c for c in cases if c not in ("ddp", "eval")], inputs)
    # the evaluators in one process at the global batch, and at the
    # ranks' per-rank batch (the same rows in the same order)
    single["eval"] = pr.case_eval(None, inputs)
    halves = [h for b in inputs["eval_batches"]
              for h in (pr.mesh.shard_batch(b, _Half(0)), pr.mesh.shard_batch(b, _Half(1)))]
    single["eval_per_rank_batch"] = pr.case_eval(None, dict(inputs, eval_batches=halves))
    ranks = pr.finish_ranks(context, tmp)
    return {"ranks": ranks, "single": single}


class _Half:
    """A stand-in group that takes half of a batch, for shard_batch."""

    def __init__(self, rank):
        self.rank, self.world = rank, 2


def _close(a, b, rtol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol)


def _step_matches(ranks, single, k=0):
    """Step k of the ranks against the single process's: losses, the flat
    gradient, the parameters after it; the ranks' parameters equal."""
    r0, r1 = (r["steps"][k] for r in ranks)
    s = single["steps"][k]
    for key in ("loss_pose", "loss_Xo", "loss_Yc", "loss_conf", "loss_all"):
        _close(r0["metrics"][key], s["metrics"][key], 1e-5)
        assert r0["metrics"][key] == r1["metrics"][key], key
    assert r0["metrics"]["overflow_frac"] == s["metrics"]["overflow_frac"]
    assert torch.equal(r0["grad"], r1["grad"])
    assert pr.rel_l2(r0["grad"], s["grad"]) < 5e-3
    assert torch.equal(r0["params"], r1["params"])
    # eps = 1: the update is close to linear in the gradient, a few 1e-7
    # of lr = 1e-3 apart at most
    assert float((r0["params"] - s["params"]).abs().max()) < 1e-6
    assert not torch.equal(r0["params"], ranks[0]["before"])


def test_masked_bn_statistics_and_backward_are_the_global_batch(runs):
    r, s = [x["masked_bn"] for x in runs["ranks"]], runs["single"]["masked_bn"]
    for part in r:
        assert float(part["count"]) == float(s["count"])
        np.testing.assert_allclose(part["mean"].numpy(), s["mean"].numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(part["var"].numpy(), s["var"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(pr.concat(r, "y").numpy(), s["y"].numpy(),
                               rtol=1e-5, atol=1e-6)
    # the input's gradient needs the backward's three global sums
    np.testing.assert_allclose(pr.concat(r, "gx").numpy(), s["gx"].numpy(),
                               rtol=1e-5, atol=1e-6)
    # the weight's and bias's gradients are each rank's share: their sum
    for key in ("gw", "gb"):
        np.testing.assert_allclose((r[0][key] + r[1][key]).numpy(), s[key].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_point_mlp_batch_norm_is_the_global_batch(runs):
    r, s = [x["point_mlp"] for x in runs["ranks"]], runs["single"]["point_mlp"]
    np.testing.assert_allclose(pr.concat(r, "y").numpy(), s["y"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pr.concat(r, "gx").numpy(), s["gx"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((r[0]["gparams"] + r[1]["gparams"]).numpy(),
                               s["gparams"].numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(r[0]["stats"], r[1]["stats"])
    np.testing.assert_allclose(r[0]["stats"].numpy(), s["stats"].numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["step", "step_fused", "step_bank", "step_unequal"])
def test_train_step_matches_single_process(runs, case):
    _step_matches([r[case] for r in runs["ranks"]], runs["single"][case])


def test_second_step_matches_single_process(runs):
    ranks = [r["step"] for r in runs["ranks"]]
    single = runs["single"]["step"]
    for key in ("loss_all", "grad_norm"):
        _close(ranks[0]["steps"][1]["metrics"][key], single["steps"][1]["metrics"][key],
               5e-2)
    assert torch.equal(ranks[0]["steps"][1]["params"], ranks[1]["steps"][1]["params"])


def test_unequal_valid_counts_weigh_rows_globally(runs):
    """Rank 0 holds 4 valid rows and rank 1 one: per-rank weights would
    give rank 1's row four times the weight of each of rank 0's."""
    ranks = [r["step_unequal"] for r in runs["ranks"]]
    equal = runs["single"]["step"]["steps"][0]["metrics"]["loss_all"]
    got = ranks[0]["steps"][0]["metrics"]["loss_all"]
    _close(got, runs["single"]["step_unequal"]["steps"][0]["metrics"]["loss_all"], 1e-5)
    assert got != pytest.approx(equal, rel=1e-3)  # the weights moved it


def test_nan_on_one_rank_skips_the_step_on_both(runs):
    for r in runs["ranks"]:
        step = r["step_nan"]["steps"][0]
        assert step["metrics"]["skipped_nonfinite"] == 1.0
        assert not np.isfinite(step["metrics"]["loss_all"])
        assert torch.equal(step["params"], r["step_nan"]["before"])
    single = runs["single"]["step_nan"]["steps"][0]
    assert single["metrics"]["skipped_nonfinite"] == 1.0


def test_remat_at_world_two(runs):
    """model.remat: the backward's recomputation reissues the BN
    collectives of its forward in the same order on both ranks: the step
    equals the ranks' step without remat, and the single process's."""
    remat = [r["step_remat"] for r in runs["ranks"]]
    plain = [r["step"] for r in runs["ranks"]]
    for a, b in zip(remat, plain):
        assert a["steps"][0]["metrics"]["loss_all"] == b["steps"][0]["metrics"]["loss_all"]
        assert torch.equal(a["steps"][0]["grad"], b["steps"][0]["grad"])
        assert torch.equal(a["steps"][0]["stats"], b["steps"][0]["stats"])
    _step_matches(remat, runs["single"]["step_remat"])


def test_stage2_refiner_step_matches_single_process(runs):
    r0, r1 = (r["stage2"] for r in runs["ranks"])
    s = runs["single"]["stage2"]
    for key in ("loss_all", "loss_last_iter"):
        _close(r0["metrics"][key], s["metrics"][key], 1e-5)
    assert pr.rel_l2(r0["grad"], s["grad"]) < 5e-3
    assert torch.equal(r0["params"], r1["params"])


def test_ddp_reducer_does_not_see_autograd_grad(runs):
    """Wrapping the model in DistributedDataParallel and taking the
    gradient with torch.autograd.grad, as the step does: nothing reaches
    .grad, and the two ranks' gradients stay their own (different)."""
    r0, r1 = (r["ddp"] for r in runs["ranks"])
    assert not r0["dot_grad_set"] and not r1["dot_grad_set"]
    assert not torch.allclose(r0["grad"], r1["grad"])


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_evaluators_summaries_equal_single_process(runs, stage):
    """Every rank returns the same summary; it equals the single process's
    evaluated at the ranks' per-rank batch (the same rows, in the same
    order, at the same shapes: a float sum at batch 8 may differ from one
    at batch 4 in its last bit), and at the global batch its counts and
    rounded means are equal and its per-class AUCs within 1e-6."""
    r0, r1 = (r["eval"][stage] for r in runs["ranks"])
    assert r0 == r1
    assert r0 == runs["single"]["eval_per_rank_batch"][stage]
    whole = runs["single"]["eval"][stage]
    for key in ("n_scored", "n_overflow", "n_lost", "auc_mean", "acc_mean"):
        assert r0[key] == whole[key], key
    np.testing.assert_allclose(r0["auc_per_class"], whole["auc_per_class"], atol=1e-6)
    assert r0["n_scored"] == 2 * pr.BATCH


def test_world_one_group_is_the_single_process_path(tmp_path):
    """A gloo group of one rank issues no collective: two steps, the
    evaluators and the BN statistics torch.equal to the run without a
    group."""
    import torch.distributed as dist

    inputs = {"batch": pr.global_batch(), "bank": pr.dataset().template_bank(),
              "model_points": pr.model_points(), "eval_batches": [pr.global_batch()]}
    group = pr.mesh.init_distributed("file://" + str(tmp_path / "rendezvous"), 1, 0,
                                     device="cpu")
    try:
        assert (group.world, group.backend) == (1, "gloo")
        one = [pr.CASES[c](group, inputs) for c in ("step", "stage2", "eval")]
    finally:
        pr.mesh.destroy(group)
    assert not dist.is_initialized()
    none = [pr.CASES[c](None, inputs) for c in ("step", "stage2", "eval")]
    for a, b in zip(one[0]["steps"], none[0]["steps"]):
        assert a["metrics"] == b["metrics"]
        for key in ("grad", "params", "stats"):
            assert torch.equal(a[key], b[key]), key
    assert one[1]["metrics"] == none[1]["metrics"]
    assert torch.equal(one[1]["grad"], none[1]["grad"])
    assert one[2] == none[2]
