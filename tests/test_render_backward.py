"""Backward-pass checks: jax.grad of the rasterizer vs central finite
differences (BASELINE config #2; SURVEY.md §4 item 3).

The reference hand-derives its backward (tiledBackward,
tiled_shaders.metal:388-738); ours is jax.grad through the block-parallel
forward, so the property to verify is grad == d(forward)/d(param).
"""

import numpy as np
import jax
import jax.numpy as jnp

from gaussiansplatting.config import RasterConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.ops.rasterize import render

from conftest import make_camera_for_scene, make_scene


def _setup(rng, n=24):
    scene = make_scene(rng, n=n, spread=0.6)
    means, log_scales, quats, raw_op, sh_dc = scene
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    params = G.from_arrays(means, log_scales, quats, raw_op, sh)
    cam = make_camera_for_scene(width=48, height=32)
    cfg = RasterConfig(pair_capacity=2048, pair_block=16)
    return params, cam, cfg


def _loss_fn(cam, cfg, weights):
    def fn(params):
        img, _ = render(params, cam, cfg)
        return jnp.sum(img * weights)

    return fn


def _fd_check(fn, params, field, idx, grad_val, eps, rtol, atol):
    """Central finite difference on one scalar parameter."""
    arr = getattr(params, field)
    up = params.replace(**{field: arr.at[idx].add(eps)})
    dn = params.replace(**{field: arr.at[idx].add(-eps)})
    fd = (float(fn(up)) - float(fn(dn))) / (2 * eps)
    np.testing.assert_allclose(grad_val, fd, rtol=rtol, atol=atol), (field, idx)
    return fd


def _random_direction(rng, params, fields):
    """Random unit direction over the given float fields (zeros elsewhere)."""
    tangent = {}
    total = 0.0
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        arr = getattr(params, f)
        if f in fields:
            v = rng.normal(size=arr.shape).astype(np.float32)
            total += float((v**2).sum())
        else:
            v = np.zeros(arr.shape, np.float32)
        tangent[f] = v
    scale = 1.0 / np.sqrt(total)
    return {k: jnp.asarray(v * scale) for k, v in tangent.items()}


def _apply_direction(params, tangent, eps):
    return params.replace(
        **{k: getattr(params, k) + eps * v for k, v in tangent.items()}
    )


def test_grad_matches_finite_differences(rng):
    """Directional FD over the whole parameter tree: much better signal/noise
    than per-scalar FD in fp32 (loss ~1e3, eval noise ~1e-4)."""
    params, cam, cfg = _setup(rng)
    weights = jnp.asarray(
        rng.uniform(0.5, 1.0, (cam.height, cam.width, 3)).astype(np.float32)
    )
    fn = jax.jit(_loss_fn(cam, cfg, weights))
    grads = jax.jit(jax.grad(_loss_fn(cam, cfg, weights), allow_int=True))(params)

    # Geometry fields (means/scales/quats) change the *discrete* structure
    # under perturbation — tile coverage, radius quantization, power windows —
    # paths that AD (correctly, like the reference and official 3DGS) does not
    # differentiate.  FD therefore only agrees loosely there; sh/opacity are
    # smooth (up to the alpha floor) and must agree tightly.  The strict AD
    # consistency check is test_vjp_consistent_with_jvp.
    # (means/log_scales/quats directions are excluded: with a sum-over-pixels
    # loss the boundary jumps dominate any FD step.  Their gradient path is
    # still covered by test_viewspace_dummy_gradient — a single-Gaussian
    # screen-position FD — and by test_vjp_consistent_with_jvp.)
    cases = [
        (("sh",), 0.05, 0.05),
        (("raw_opacities",), 0.08, 0.2),
    ]
    for fields, rtol, atol in cases:
        tangent = _random_direction(rng, params, fields)
        dir_grad = sum(
            float(jnp.vdot(getattr(grads, k), v)) for k, v in tangent.items()
        )
        eps = 1e-2
        fd = (
            float(fn(_apply_direction(params, tangent, eps)))
            - float(fn(_apply_direction(params, tangent, -eps)))
        ) / (2 * eps)
        assert abs(dir_grad - fd) < rtol * abs(fd) + atol, (
            f"{fields}: grad {dir_grad} vs fd {fd}"
        )


def test_vjp_consistent_with_jvp(rng):
    """Reverse-mode (our training path) vs forward-mode on random directions —
    independent AD code paths must agree to fp32 precision.  (Forward mode
    requires the plain-autodiff pair pipeline; custom_vjp has no JVP rule.)"""
    params, cam, cfg = _setup(rng, n=16)
    cfg = cfg.replace(grad_reduce="autodiff")
    weights = jnp.ones((cam.height, cam.width, 3), jnp.float32)

    trainable = ("means", "log_scales", "quats", "raw_opacities", "sh")

    def fn(tr):
        p = params.replace(**tr)
        img, _ = render(p, cam, cfg)
        return jnp.sum(img * weights)

    tr = {k: getattr(params, k) for k in trainable}
    grads = jax.jit(jax.grad(fn))(tr)
    for _ in range(3):
        tangent = _random_direction(rng, params, trainable)
        _, jvp_val = jax.jvp(fn, (tr,), (tangent,))
        vjp_val = sum(float(jnp.vdot(grads[k], v)) for k, v in tangent.items())
        np.testing.assert_allclose(vjp_val, float(jvp_val), rtol=1e-3, atol=1e-3)


def test_sh_dc_gradient(rng):
    params, cam, cfg = _setup(rng)
    weights = jnp.ones((cam.height, cam.width, 3), jnp.float32)
    grads = jax.jit(jax.grad(_loss_fn(cam, cfg, weights), allow_int=True))(params)
    fn = jax.jit(_loss_fn(cam, cfg, weights))
    # DC terms of contributing gaussians get gradient; higher-order never do
    # (forward renders DC only, tiled_shaders.metal:297-301)
    assert float(jnp.abs(grads.sh[:, 0, :]).sum()) > 0
    np.testing.assert_allclose(np.asarray(grads.sh[:, 1:, :]), 0.0)
    i = int(jnp.argmax(jnp.abs(grads.sh[:, 0, 0])))
    g = float(grads.sh[i, 0, 0])
    _fd_check(fn, params, "sh", (i, 0, 0), g, 1e-3, rtol=0.05, atol=1e-3)


def test_viewspace_dummy_gradient(rng):
    """The vs_dummy cotangent equals the screen-space positional gradient used
    by density control (reference: viewspace_grad, tiled_shaders.metal:717-720)."""
    params, cam, cfg = _setup(rng)
    cfg = cfg.replace(grad_reduce="autodiff")  # JVP check below needs fwd-mode
    weights = jnp.asarray(
        rng.uniform(0.5, 1.0, (cam.height, cam.width, 3)).astype(np.float32)
    )

    def fn(vs):
        img, _ = render(params, cam, cfg, vs_dummy=vs)
        return jnp.sum(img * weights)

    zeros = jnp.zeros((params.capacity, 2), jnp.float32)
    vgrad = jax.jit(jax.grad(fn))(zeros)
    assert float(jnp.abs(vgrad).sum()) > 0

    # Verify against forward-mode AD (an independent code path).  Central
    # finite differences of the pixel-summed loss are unusable here: in fp32
    # the perturbed sums cancel catastrophically and the FD estimate swings
    # +/-30% around the true derivative regardless of eps.
    i = int(jnp.argmax(jnp.abs(vgrad[:, 0])))
    tangent = zeros.at[i, 0].set(1.0)
    _, jvp_val = jax.jvp(fn, (zeros,), (tangent,))
    np.testing.assert_allclose(float(vgrad[i, 0]), float(jvp_val), rtol=1e-4)


def test_dead_gaussians_get_no_gradient(rng):
    params, cam, cfg = _setup(rng, n=16)
    params = params.replace(alive=params.alive.at[0].set(False))
    weights = jnp.ones((cam.height, cam.width, 3), jnp.float32)
    grads = jax.jit(jax.grad(_loss_fn(cam, cfg, weights), allow_int=True))(params)
    np.testing.assert_allclose(np.asarray(grads.means[0]), 0.0)
    np.testing.assert_allclose(float(grads.raw_opacities[0]), 0.0)


def test_gradients_finite(rng):
    params, cam, cfg = _setup(rng, n=48)
    weights = jnp.ones((cam.height, cam.width, 3), jnp.float32)
    grads = jax.jit(jax.grad(_loss_fn(cam, cfg, weights), allow_int=True))(params)
    for leaf in jax.tree_util.tree_leaves(grads):
        assert bool(jnp.all(jnp.isfinite(leaf)))


def test_grad_reduce_modes_agree(rng):
    """All three per-Gaussian gradient reductions — the sort + segmented
    scan custom VJP (default), the fused scatter-add custom VJP, and plain
    autodiff through the pair pipeline — produce the same gradients."""
    params, cam, cfg = _setup(rng, n=32)
    weights = jnp.asarray(
        rng.uniform(0.5, 1.0, (cam.height, cam.width, 3)).astype(np.float32)
    )
    grads = {}
    for mode in ("sortprefix", "scatter", "autodiff"):
        fn = _loss_fn(cam, cfg.replace(grad_reduce=mode), weights)
        grads[mode] = jax.jit(jax.grad(fn, allow_int=True))(params)
    for mode in ("sortprefix", "autodiff"):
        for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
            a = np.asarray(getattr(grads[mode], f))
            b = np.asarray(getattr(grads["scatter"], f))
            rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-12)
            assert rel < 5e-4, f"{mode}/{f}: rel {rel}"
