"""The port's rotations, poses, metrics and Wigner-D against the JAX package.

dcl_net_tpu_torch/geometry/{rotation,transform,wigner}.py against
dcl_net_tpu/geometry/ on the same numpy-seeded inputs: rotations, poses and
metrics within 1e-6, Wigner-D values within 1e-6 and its gradient (in
the three angles and in a matrix's entries)
against jax.grad within 1e-5 (the angles' gradient finite at beta = 0
and pi; a matrix's is infinite there in both packages, through arccos).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcl_net_tpu.geometry import rotation as jrot
from dcl_net_tpu.geometry import transform as jtr
from dcl_net_tpu.geometry import wigner as jw
from dcl_net_tpu_torch import geometry as tgeo
from dcl_net_tpu_torch.geometry import rotation as trot
from dcl_net_tpu_torch.geometry import transform as ttr
from dcl_net_tpu_torch.geometry import wigner as tw

TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=tol,
                               atol=tol)


def _rot(rng, n):
    return np.asarray(jrot.quaternion_to_matrix(jnp.asarray(rng.randn(n, 4).astype(np.float32))))


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["cross_product", "ortho6d_to_matrix", "quaternion_to_matrix",
                                  "matrix_to_quaternion", "axis_angle_to_matrix",
                                  "euler_to_matrix", "quaternion_multiply",
                                  "quaternion_conjugate", "translate_rotate"])
def test_rotation_functions_match_jax(name):
    rng = np.random.RandomState(0)
    v3 = [rng.randn(6, 3).astype(np.float32) for _ in range(2)]
    q = [rng.randn(6, 4).astype(np.float32) for _ in range(2)]
    ang = [rng.uniform(-np.pi, np.pi, 6).astype(np.float32) for _ in range(3)]
    args = {
        "cross_product": v3,
        "ortho6d_to_matrix": v3,
        "quaternion_to_matrix": q[:1],
        # the four branches of the candidate choice: identity, and 180 degrees
        # about each axis, besides random rotations
        "matrix_to_quaternion": [np.concatenate([
            _rot(rng, 6), np.eye(3, dtype=np.float32)[None],
            np.diag([1, -1, -1]).astype(np.float32)[None],
            np.diag([-1, 1, -1]).astype(np.float32)[None],
            np.diag([-1, -1, 1]).astype(np.float32)[None]])],
        "axis_angle_to_matrix": [v3[0], ang[0]],
        "euler_to_matrix": ang,
        "quaternion_multiply": q,
        "quaternion_conjugate": q[:1],
        "translate_rotate": [rng.randn(6, 5, 3).astype(np.float32), v3[0], _rot(rng, 6)],
    }[name]
    want = getattr(jrot, name)(*map(jnp.asarray, args))
    got = getattr(trot, name)(*map(T, args))
    _close(got, want)


def test_random_rotation_is_a_rotation_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    r = trot.random_rotation(gen, (4, 2))
    assert r.shape == (4, 2, 3, 3)
    eye = torch.eye(3).expand(4, 2, 3, 3)
    torch.testing.assert_close(r @ r.transpose(-1, -2), eye, atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.linalg.det(r), torch.ones(4, 2), atol=1e-6, rtol=0)
    again = trot.random_rotation(torch.Generator().manual_seed(3), (4, 2))
    assert torch.equal(r, again)
    # the same map as JAX's from the drawn quaternions
    q = torch.randn((4, 2, 4), generator=torch.Generator().manual_seed(3))
    _close(r, jrot.quaternion_to_matrix(jnp.asarray(q.numpy())))


@pytest.mark.parametrize("name", ["compose_pose", "invert_pose", "add_metric", "adds_metric"])
def test_pose_and_metric_functions_match_jax(name):
    rng = np.random.RandomState(1)
    r1, r2 = _rot(rng, 5), _rot(rng, 5)
    t1, t2 = (rng.randn(5, 3).astype(np.float32) * 0.1 for _ in range(2))
    p1, p2 = (rng.randn(5, 64, 3).astype(np.float32) * 0.05 for _ in range(2))
    args = {"compose_pose": [r1, t1, r2, t2], "invert_pose": [r1, t1],
            "add_metric": [p1, p2], "adds_metric": [p1, p2]}[name]
    want = getattr(jtr, name)(*map(jnp.asarray, args))
    got = getattr(ttr, name)(*map(T, args))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_geometry_package_exports_the_jax_names():
    import dcl_net_tpu.geometry as jgeo

    public = [n for n in dir(jgeo) if not n.startswith("_")
              and callable(getattr(jgeo, n))]
    assert public
    for n in public:
        assert callable(getattr(tgeo, n)), n


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_wigner_numpy_part_is_the_jax_package_copy(l):
    rng = np.random.RandomState(l)
    a, b, g = rng.uniform(-np.pi, np.pi), rng.uniform(0, np.pi), rng.uniform(-np.pi, np.pi)
    np.testing.assert_array_equal(tw.small_d(l, b), jw.small_d(l, b))
    np.testing.assert_array_equal(tw.wigner_d_complex(l, a, b, g), jw.wigner_d_complex(l, a, b, g))
    np.testing.assert_array_equal(tw.wigner_D(l, a, b, g), jw.wigner_D(l, a, b, g))
    r = tw.zyz_to_matrix(a, b, g)
    np.testing.assert_array_equal(r, jw.zyz_to_matrix(a, b, g))
    assert tw.matrix_to_zyz(r) == jw.matrix_to_zyz(r)
    np.testing.assert_array_equal(tw.D_from_matrix(l, r), jw.D_from_matrix(l, r))


@pytest.mark.parametrize("beta", [0.0, 0.7, np.pi])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_wigner_torch_values_and_gradients_match_jax(l, beta):
    rng = np.random.RandomState(10 * l)
    a, g = np.float32(rng.uniform(-np.pi, np.pi)), np.float32(rng.uniform(-np.pi, np.pi))
    b = np.float32(beta)
    w = rng.randn(2 * l + 1, 2 * l + 1).astype(np.float32)
    angles = [torch.tensor(x, requires_grad=True) for x in (a, b, g)]
    got = tw.wigner_D_torch(l, *angles)
    _close(got, jw.wigner_D_jax(l, a, b, g))
    _close(got, jw.wigner_D(l, float(a), float(b), float(g)), 1e-5)
    _close(tw.small_d_torch(l, angles[1]), jw.small_d_jax(l, b))
    (got * T(w)).sum().backward()
    want = jax.grad(lambda x, y, z: jnp.sum(jw.wigner_D_jax(l, x, y, z) * w),
                    argnums=(0, 1, 2))(a, b, g)
    for t, j in zip(angles, want):
        assert torch.isfinite(t.grad)
        _close(t.grad, j, 1e-5)


@pytest.mark.parametrize("beta", [0.0, 0.9, np.pi])
def test_wigner_of_a_matrix_and_its_gradient_match_jax(beta):
    rng = np.random.RandomState(5)
    r = tw.zyz_to_matrix(rng.uniform(-np.pi, np.pi), beta,
                         rng.uniform(-np.pi, np.pi)).astype(np.float32)
    w = rng.randn(5, 5).astype(np.float32)
    a, b, g = tw.matrix_to_zyz_torch(T(r))
    ja, jb, jg = jw.matrix_to_zyz_jax(jnp.asarray(r))
    for x, y in ((a, ja), (b, jb), (g, jg)):
        _close(x, y)
    rt = T(r).requires_grad_(True)
    got = tw.D_from_matrix_torch(2, rt)
    _close(got, jw.D_from_matrix_jax(2, jnp.asarray(r)))
    (got * T(w)).sum().backward()
    want = jax.grad(lambda m: jnp.sum(jw.D_from_matrix_jax(2, m) * w))(jnp.asarray(r))
    # on the gimbal set d arccos / d r22 is infinite in both packages
    assert torch.isfinite(rt.grad).all() == (0 < beta < np.pi)
    _close(rt.grad, want, 1e-5)
