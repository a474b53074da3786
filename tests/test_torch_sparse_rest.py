"""The rest of the port's sparse-conv ops against the JAX package's.

dcl_net_tpu_torch/ops/sparse_conv.py against dcl_net_tpu/ops/sparse_conv.py
on the same numpy-seeded grids, within 1e-6: sparse_max_pool's forward
(zero_init on and off, a window of negative values only, an empty window)
and its gradient, on values drawn from a few integers so that ties are
everywhere (each tied input gets the whole dout); sparse_conv_transpose;
sparse_inverse_conv, also where the forward conv's size formula floors
and on the ValueError of a too-short prev_mask; and dilate_mask and
sparse_avg_pool at the JAX signatures' other options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.ops import sparse_conv as jsc
from dcl_net_tpu_torch.ops import sparse_conv as tsc

torch.set_num_threads(2)

TOL = 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def _grid(seed, b=2, d=9, c=4, occupancy=0.4, ties=False):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(b, d, d, d) < occupancy).astype(np.float32)
    if ties:  # a few integers: equal values in most windows, negatives too
        feats = rng.randint(-3, 3, (b, d, d, d, c)).astype(np.float32)
    else:
        feats = rng.randn(b, d, d, d, c).astype(np.float32)
    feats[0, :3, :3, :3] = -np.abs(feats[0, :3, :3, :3]) - 1.0  # negative windows
    mask[1, -3:, -3:, -3:] = 0.0  # empty windows
    return feats, mask


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("zero_init", [True, False])
@pytest.mark.parametrize("geometry", [(3, 2, None), (2, 2, 0), (3, 1, 1)])
def test_sparse_max_pool_and_its_gradient_match_jax(geometry, zero_init, ties):
    kernel, stride, padding = geometry
    feats, mask = _grid(0 if ties else 1, ties=ties)
    want, vjp = jax.vjp(lambda f: jsc.sparse_max_pool(f, jnp.asarray(mask), kernel, stride,
                                                      padding, zero_init)[0],
                        jnp.asarray(feats))
    _, want_mask = jsc.sparse_max_pool(jnp.asarray(feats), jnp.asarray(mask), kernel, stride,
                                       padding, zero_init)
    ft = T(feats).requires_grad_(True)
    got, got_mask = tsc.sparse_max_pool(ft, T(mask), kernel, stride, padding, zero_init)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    dout = np.random.RandomState(2).randn(*want.shape).astype(np.float32)
    (got * T(dout)).sum().backward()
    (wgrad,) = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(wgrad), rtol=TOL, atol=TOL)
    if ties:  # some input received the dout of more than one output, or a tie
        assert (np.abs(ft.grad.numpy()) > 0).sum() > 0


def test_sparse_max_pool_tie_gives_every_tied_input_the_whole_dout():
    feats = np.zeros((1, 2, 2, 2, 1), np.float32)
    feats[0, 0, 0, 0, 0] = feats[0, 1, 1, 1, 0] = 5.0
    mask = np.ones((1, 2, 2, 2), np.float32)
    ft = T(feats).requires_grad_(True)
    out, _ = tsc.sparse_max_pool(ft, T(mask), kernel=2, stride=2, padding=0)
    assert out.shape == (1, 1, 1, 1, 1) and float(out.detach()) == 5.0
    out.sum().backward()
    assert float(ft.grad[0, 0, 0, 0, 0]) == float(ft.grad[0, 1, 1, 1, 0]) == 1.0
    assert float(ft.grad.sum()) == 2.0


@pytest.mark.parametrize("geometry", [(3, 2, 0), (3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_sparse_conv_transpose_matches_jax(geometry):
    k, stride, padding = geometry
    feats, mask = _grid(3, d=5, c=3)
    w = np.random.RandomState(4).randn(k, k, k, 3, 6).astype(np.float32)
    want, wmask = jsc.sparse_conv_transpose(jnp.asarray(feats), jnp.asarray(mask),
                                            jnp.asarray(w), stride, padding)
    got, gmask = tsc.sparse_conv_transpose(T(feats), T(mask), T(w), stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-5)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("d_prev", [9, 10, 11])  # 10: the forward conv floored
@pytest.mark.parametrize("padding", [0, 1])
def test_sparse_inverse_conv_matches_jax(d_prev, padding):
    k, stride = 3, 2
    d_down = (d_prev + 2 * padding - k) // stride + 1
    feats, mask = _grid(5, d=d_down, c=3, occupancy=0.6)
    prev = (np.random.RandomState(6).rand(2, d_prev, d_prev, d_prev) < 0.5).astype(np.float32)
    w = np.random.RandomState(7).randn(k, k, k, 3, 5).astype(np.float32)
    want, _ = jsc.sparse_inverse_conv(jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(w),
                                      jnp.asarray(prev), stride, padding)
    got, gmask = tsc.sparse_inverse_conv(T(feats), T(mask), T(w), T(prev), stride, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-5)
    assert torch.equal(gmask, T(prev))


def test_sparse_inverse_conv_refuses_a_short_prev_mask():
    feats, mask = _grid(8, d=5, c=3)
    w = np.zeros((3, 3, 3, 3, 2), np.float32)
    prev = np.ones((2, 4, 4, 4), np.float32)
    with pytest.raises(ValueError, match="shorter than the conv geometry"):
        jsc.sparse_inverse_conv(jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(w),
                                jnp.asarray(prev))
    with pytest.raises(ValueError, match="shorter than the conv geometry"):
        tsc.sparse_inverse_conv(T(feats), T(mask), T(w), T(prev))


@pytest.mark.parametrize("kw", [dict(kernel=3), dict(kernel=3, stride=2),
                                dict(kernel=3, stride=2, padding=0)])
def test_dilate_mask_matches_jax(kw):
    _, mask = _grid(9)
    np.testing.assert_array_equal(tsc.dilate_mask(T(mask), **kw).numpy(),
                                  np.asarray(jsc.dilate_mask(jnp.asarray(mask), **kw)))


@pytest.mark.parametrize("kw", [dict(), dict(use_gs=True), dict(kernel=2, padding=0)])
def test_sparse_avg_pool_options_match_jax(kw):
    feats, mask = _grid(10)
    want = jsc.sparse_avg_pool(jnp.asarray(feats), jnp.asarray(mask), **kw)
    got = tsc.sparse_avg_pool(T(feats), T(mask), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
