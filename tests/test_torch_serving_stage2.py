"""The port's stage-2 serving artifact against the JAX package's, on the
same weights: the stage-1 model and inputs of tests/test_torch_serving.py,
and a JAX Refiner (biases drawn away from zero) carried into the port. The
refined .pt2 artifact, saved and loaded again, must be torch.equal to the
port's direct stage-1 + refiner module on the CPU and within 1e-5 of JAX's
make_serve_fn_stage2.
"""

import torch

from dcl_net_tpu_torch import serving
from tests.test_torch_serving import (  # noqa: F401  (setup: a pytest fixture)
    B, ITERATIONS, KEYS, N, _args, _assert_close_to_jax, _assert_equal, _jax_direct, setup,
)
from tests.test_torch_stage2 import _port_refiner, _refiner_variables

torch.set_num_threads(2)


def test_export_stage2_roundtrip_matches_direct_and_jax(setup):
    """The refined artifact equals the direct stage-1 + refiner module and
    JAX's make_serve_fn_stage2; the refiner moves the pose, which stays a
    rotation."""
    jrefiner, rvars = _refiner_variables(seed=7, n=N)
    refiner = _port_refiner(rvars, n=N)
    data = serving.export_serve_stage2(setup["model"], refiner, setup["bank"], B,
                                       iterations=ITERATIONS)
    got = serving.load_serve(data)(*_args(setup))
    assert set(got) == KEYS | {"rot_stage1", "trans_stage1"}
    cache = serving.encode_template_cache(setup["model"], setup["bank"])
    direct = serving.make_serve_fn_stage2(setup["model"], refiner, cache, ITERATIONS)
    with torch.no_grad():
        _assert_equal(got, direct(*_args(setup)))
    _assert_close_to_jax(got, _jax_direct(setup, stage2=(jrefiner, rvars)))
    assert (got["rot_pred"] - got["rot_stage1"]).abs().max() > 1e-6
    r = got["rot_pred"].double()
    torch.testing.assert_close(r @ r.transpose(1, 2), torch.eye(3, dtype=r.dtype).expand_as(r),
                               rtol=0, atol=1e-4)
