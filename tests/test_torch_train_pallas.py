"""One train step of the port against the JAX package's Pallas path.

The JAX DCLNet with interp_mode="pallas" runs its compaction and
interpolation kernels and their custom VJPs (the TPU kernels K2-K5) in
interpret mode; the port runs the plain versions of its kernels on the same
bridged weights and batch as tests/test_torch_train_model.py.
"""

import numpy as np
import jax
import torch

from dcl_net_tpu.models import DCLNet as JaxDCLNet
from tests.test_torch_train_model import (
    KW,
    LOSSES,
    N,
    as_f64,
    assert_stats_close,
    build_setup,
    jax_step,
    leaves,
    torch_step,
)

torch.set_num_threads(2)


def test_train_step_matches_jax_pallas_path():
    """One train step on the JAX Pallas path (compaction, interpolation and
    their custom VJPs in interpret mode), f64 outside the kernels."""
    jexact, variables, batch, _ = build_setup()
    pallas = JaxDCLNet(interp_mode="pallas", n_inp=N, n_tmp=N, **KW)
    v64, b64 = as_f64(variables), as_f64(batch)
    with jax.enable_x64(True):
        want, want_grads, want_stats = jax_step(pallas, v64, b64)
        _, exact_grads, _ = jax_step(jexact, v64, b64)
    got, got_grads, got_stats = torch_step(v64, batch, torch.float64)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    assert_stats_close(got_stats, want_stats, 1e-5)
    # The Pallas kernels compute in f32 inside the f64 model. Their rounding
    # (~6e-8 relative) reaches the gradients amplified by the network's
    # conditioning (see test_torch_train_model.py), up to 1e-2 of a leaf's
    # largest entry. So the port is held as close to the Pallas path as the
    # JAX package's own exact path is, per leaf (twice that distance, plus
    # 1e-4 of the leaf's scale), and the exact path within 1e-4 above.
    got, want, exact = (dict(leaves(t)) for t in (got_grads, want_grads, exact_grads))
    assert set(got) == set(want)
    for path in want:
        scale = np.abs(want[path]).max()
        own = np.abs(exact[path] - want[path]).max()
        err = np.abs(got[path] - want[path]).max()
        assert err <= 2 * own + 1e-4 * scale, f"{'/'.join(path)}: {err} vs {own}"
