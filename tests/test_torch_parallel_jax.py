"""Data parallelism of the port against the JAX package: 2 gloo ranks
take 3 f64 train steps (tests/parallel_ranks.py, each rank on its block
of a global batch of 8 rows at the 16^3 test size) from the weights of a
JAX DCLNet carried by weights.py, and JAX's single-device make_train_step
takes the same 3 steps on the same 8 rows. The tolerance is that of
tests/test_torch_train_solver.py::test_train_steps_match_jax_make_train_step
(f64 on both sides, Adam with eps = 1): parameters and BN running
statistics within 1e-6 absolute, the metrics within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.models import DCLNet as JaxDCLNet
from tests import parallel_ranks as pr
from tests.test_torch_train_model import as_f64
from tests.test_torch_train_solver import _jax_steps

torch.set_num_threads(2)

ATOL_JAX = 1e-6  # f64 parameters and BN statistics, as test_torch_train_solver.py


def _jax_setup(batch):
    """(JAX model, its bridged f64 variables, running statistics randomised
    as tests/test_torch_train_model.py::build_setup does)."""
    jmodel = JaxDCLNet(n_inp=pr.N, n_tmp=pr.N, **pr.KW)
    init = jax.jit(lambda k, b: jmodel.init(k, b, train=False))
    variables = jax.tree.map(
        np.asarray, init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch)))
    rng = np.random.RandomState(1)
    stats = jax.tree.map(
        lambda a: (rng.randn(*a.shape) * 0.1 + (a > 0.5)).astype(np.float32),
        variables["batch_stats"])
    return jmodel, as_f64({"params": variables["params"], "batch_stats": stats})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": the ranks' steps, "jax": JAX's}: the ranks run while JAX
    compiles and takes its steps."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    batch = pr.global_batch()
    jmodel, v64 = _jax_setup(batch)
    context = pr.start_ranks(tmp, {"batch": batch, "variables": v64}, ["step_f64"])
    with jax.enable_x64(True):
        want = _jax_steps(jmodel, v64, as_f64(batch), 3)
    ranks = pr.finish_ranks(context, tmp)
    return {"ranks": [r["step_f64"] for r in ranks], "jax": want}


def test_f64_steps_match_jax_single_device_step(runs):
    """The ranks' 3 f64 steps against JAX's single-device make_train_step on
    the same 8 rows and carried weights."""
    from dcl_net_tpu_torch.models.dcl_net import DCLNet
    from dcl_net_tpu_torch.weights import to_jax_variables
    from tests.test_torch_train_model import leaves

    ranks = runs["ranks"]
    for k, (want_params, want_stats, want_metrics) in enumerate(runs["jax"]):
        got_step = ranks[0]["steps"][k]
        assert torch.equal(got_step["params"], ranks[1]["steps"][k]["params"])
        for key in ("loss_all", "grad_norm", "overflow_frac", "skipped_nonfinite"):
            np.testing.assert_allclose(got_step["metrics"][key], want_metrics[key],
                                       rtol=1e-5, err_msg=key)
        if k not in (0, 2):
            continue
        model = DCLNet(device="cpu", **pr.KW).double()
        params = [p for p in model.parameters() if p.requires_grad]
        stats = [b for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
        with torch.no_grad():
            for t, v in ((params, got_step["params"]), (stats, got_step["stats"])):
                for x, part in zip(t, v.split([x.numel() for x in t])):
                    x.copy_(part.view_as(x))
        got = to_jax_variables(model)
        for tree, want in (("params", want_params), ("batch_stats", want_stats)):
            mine = dict(leaves(got[tree]))
            for path, w in leaves(want):
                np.testing.assert_allclose(mine[path], w, rtol=0, atol=ATOL_JAX,
                                           err_msg="/".join(path))
