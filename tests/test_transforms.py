"""Unit tests for core math primitives vs closed form (SURVEY.md §4 item 1)."""

import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from gaussiansplatting.core import transforms as T


def test_quat_to_rotmat_matches_scipy(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ours = np.asarray(T.quat_to_rotmat(jnp.asarray(q)))
    # scipy uses (x, y, z, w)
    theirs = Rotation.from_quat(q[:, [1, 2, 3, 0]]).as_matrix()
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_quat_identity():
    R = np.asarray(T.quat_to_rotmat(jnp.array([1.0, 0, 0, 0])))
    np.testing.assert_allclose(R, np.eye(3), atol=1e-7)


def test_normalize_quat_degenerate():
    q = jnp.array([[1e-5, 0, 0, 0], [0.0, 2.0, 0, 0]])
    out = np.asarray(T.normalize_quat(q))
    np.testing.assert_allclose(out[0], [1, 0, 0, 0])  # degenerate -> identity
    np.testing.assert_allclose(out[1], [0, 1, 0, 0], atol=1e-6)


def test_covariance_3d_closed_form(rng):
    q = rng.normal(size=(4,)).astype(np.float32)
    q /= np.linalg.norm(q)
    s = np.array([0.5, 1.0, 2.0], np.float32)
    cov = np.asarray(T.covariance_3d(jnp.asarray(s), jnp.asarray(q)))
    R = np.asarray(T.quat_to_rotmat(jnp.asarray(q)))
    expected = R @ np.diag(s**2) @ R.T
    np.testing.assert_allclose(cov, expected, atol=1e-5)
    # symmetric positive definite
    np.testing.assert_allclose(cov, cov.T, atol=1e-6)
    assert np.all(np.linalg.eigvalsh(cov) > 0)


def test_clamp_scale_aspect():
    # The reference (tiled_shaders.metal:163-170) rescales ALL axes uniformly
    # so the max equals 20x the ORIGINAL min — the ratio is preserved, the
    # Gaussian just shrinks.  Match that exactly.
    s = jnp.array([[1.0, 1.0, 30.0], [1.0, 2.0, 3.0]])
    out = np.asarray(T.clamp_scale_aspect(s, 20.0))
    np.testing.assert_allclose(out[0], np.array([1.0, 1.0, 30.0]) * (20.0 / 30.0),
                               rtol=1e-6)
    np.testing.assert_allclose(out[1], [1.0, 2.0, 3.0])  # untouched under limit


def test_conic_is_inverse():
    cov = jnp.array([[2.0, 0.3, 1.0]])
    conic, det, valid = T.conic_from_cov2d(cov)
    assert bool(valid[0])
    m = np.array([[2.0, 0.3], [0.3, 1.0]])
    inv = np.linalg.inv(m)
    np.testing.assert_allclose(
        np.asarray(conic[0]), [inv[0, 0], inv[0, 1], inv[1, 1]], rtol=1e-5
    )


def test_conic_invalid_low_det():
    cov = jnp.array([[1e-3, 0.0, 1e-3]])  # det 1e-6 < 1e-4
    _, _, valid = T.conic_from_cov2d(cov)
    assert not bool(valid[0])


def test_radius_eigenvalue():
    # The reference floors the discriminant at 0.1 (tiled_shaders.metal:253):
    # lambda1 = mid + sqrt(max(0.1, mid^2 - det)).
    cov = jnp.array([[4.0, 0.0, 4.0]])
    r = np.asarray(T.radius_from_cov2d(cov))
    assert r[0] == np.ceil(3.0 * np.sqrt(4.0 + np.sqrt(0.1)))
    # cap at 512
    cov = jnp.array([[1e6, 0.0, 1e6]])
    assert np.asarray(T.radius_from_cov2d(cov))[0] == 512.0


def test_sh_roundtrip(rng):
    rgb = rng.uniform(0.1, 0.9, (8, 3)).astype(np.float32)
    back = np.asarray(T.sh_dc_to_rgb(T.rgb_to_sh_dc(jnp.asarray(rgb))))
    np.testing.assert_allclose(back, rgb, atol=1e-6)


def test_sh_eval_degree0_matches_dc(rng):
    sh = rng.normal(size=(8, 4, 3)).astype(np.float32)
    dirs = rng.normal(size=(8, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d0 = np.asarray(T.sh_eval(jnp.asarray(sh), jnp.asarray(dirs), 0))
    dc = np.asarray(T.sh_dc_to_rgb(jnp.asarray(sh[:, 0, :])))
    np.testing.assert_allclose(d0, dc, atol=1e-7)


def test_sh_eval_degree1_view_dependent(rng):
    sh = np.zeros((1, 4, 3), np.float32)
    sh[0, 0] = 0.0          # DC -> 0.5 gray
    sh[0, 3, 0] = 1.0       # band-1 x coefficient, red channel
    plus_x = np.asarray(T.sh_eval(jnp.asarray(sh), jnp.asarray([[1.0, 0, 0]]), 1))
    minus_x = np.asarray(T.sh_eval(jnp.asarray(sh), jnp.asarray([[-1.0, 0, 0]]), 1))
    # basis term is -SH_C1 * x * sh3
    np.testing.assert_allclose(plus_x[0, 0], np.clip(0.5 - T.SH_C1, 0, 1), atol=1e-6)
    np.testing.assert_allclose(minus_x[0, 0], np.clip(0.5 + T.SH_C1, 0, 1), atol=1e-6)
    # green/blue unaffected
    np.testing.assert_allclose(plus_x[0, 1:], 0.5, atol=1e-7)


def test_sh_degree1_render_gradient_reaches_band1(rng):
    """With sh_degree=1 the render gradient flows to the band-1 coefficients
    (impossible in the reference: its backward only writes DC,
    tiled_shaders.metal:505-513)."""
    import jax
    from gaussiansplatting.config import RasterConfig
    from gaussiansplatting.core import gaussians as G
    from gaussiansplatting.ops.rasterize import render
    from conftest import make_camera_for_scene, make_scene

    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=24, spread=0.6)
    sh = np.zeros((24, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    params = G.from_arrays(means, log_scales, quats, raw_op, sh)
    cam = make_camera_for_scene(width=48, height=48)
    cfg = RasterConfig(pair_capacity=1024, pair_block=16, sh_degree=1)

    def loss(sh):
        img, _ = render(params.replace(sh=sh), cam, cfg)
        return jnp.sum(img)

    g = jax.jit(jax.grad(loss))(params.sh)
    assert float(jnp.abs(g[:, 1:, :]).sum()) > 0
