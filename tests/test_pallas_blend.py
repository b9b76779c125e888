"""Pallas-Triton block-blend kernels vs the XLA reference path.

On the CPU the kernels run in the Pallas interpreter (interpret=True, or
the ``blend_interpret`` fixture for the render path); the ``gpu``-marked
cases compile them for the card and run there (chip_smoke.py phase (b) runs
them).

Locks in: identical forward images, identical gradients for all five
parameter groups, and the hand-derived replay backward against jax.grad of
the XLA blend (rasterize._block_blend), including the straight-through
gradient of the alpha cap and the dispatch rules of blend_impl."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gaussiansplatting.config import RasterConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.ops import rasterize
from gaussiansplatting.ops.rasterize import render
from gaussiansplatting.ops.pallas_blend import block_blend_cols

from conftest import make_camera_for_scene, make_scene

CONSTS = (16, -4.5, 0.99, 1.0 / 255.0)
NAMES = ("mux", "muy", "ca", "cb", "cc", "op", "cr", "cg", "cbl")


def _params(rng, n=48):
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return G.from_arrays(means, log_scales, quats, raw_op, sh)


def _cfgs():
    """(XLA scan, kernel): "auto" is the kernel on the GPU and, under the
    blend_interpret fixture, the kernel in the interpreter on the CPU."""
    kw = dict(pair_capacity=2048, pair_block=16)
    return (
        RasterConfig(**kw, blend_impl="xla"),
        RasterConfig(**kw, blend_impl="auto"),
    )


def _cols(rng, nb, b, scene, cap_hit=False):
    """Nine random [nb, b] pair columns.  "sparse": small splats scattered
    over the tile (most pixels see few pairs); "dense": wide splats piled on
    the tile center (deep overlap, T driven far down).  The last three
    slots of every block are padding (op = 0), as the pair layout leaves
    them."""
    def arr(lo, hi):
        return rng.uniform(lo, hi, (nb, b)).astype(np.float32)

    if scene == "sparse":
        mux, muy = arr(-9.0, 9.0), arr(-9.0, 9.0)
        ca, cc = arr(0.2, 1.5), arr(0.2, 1.5)
    else:
        mux, muy = arr(-2.0, 2.0), arr(-2.0, 2.0)
        ca, cc = arr(0.01, 0.08), arr(0.01, 0.08)
    cb = arr(-0.5, 0.5) * np.sqrt(ca * cc)      # positive definite conic
    op = arr(0.05, 0.95)
    if cap_hit:
        op[:, ::2] = rng.uniform(1.0, 1.5, op[:, ::2].shape)  # alpha > 0.99
    op[:, -3:] = 0.0
    cr, cg, cbl = arr(0, 1), arr(0, 1), arr(0, 1)
    return tuple(
        jnp.asarray(c) for c in (mux, muy, ca, cb, cc, op, cr, cg, cbl)
    )


def _xla_blend(cols, consts=CONSTS):
    """The XLA path's per-block blend on the same nine columns, laid out
    like the kernel's output: [NB, 4, P2]."""
    ts = consts[0]
    mux, muy, ca, cb, cc, op, cr, cg, cbl = cols
    cfg = RasterConfig(tile_size=ts, power_floor=consts[1],
                       alpha_cap=consts[2], alpha_floor=consts[3])
    c_b, s_b = rasterize._block_blend(
        jnp.stack([mux, muy], -1), jnp.stack([ca, cb, cc], -1), op,
        jnp.stack([cr, cg, cbl], -1), op > 0.0,
        rasterize._pixel_features(ts), cfg,
    )
    return jnp.concatenate([c_b.transpose(0, 2, 1), s_b[:, None, :]], axis=1)


@pytest.mark.parametrize("scene", ["sparse", "dense"])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_kernel_forward_matches_block_blend(rng, block, scene):
    cols = _cols(rng, 6, block, scene)
    out = block_blend_cols(*cols, CONSTS, True)
    ref = _xla_blend(cols)
    assert out.shape == (6, 4, 256)
    assert float(jnp.max(out[:, :3])) > 0.05          # blend not all-dead
    # colors: f32 sums in another order, and the sequential T product
    # against the log-space exp(cumsum)
    np.testing.assert_allclose(np.asarray(out[:, :3]), np.asarray(ref[:, :3]),
                               atol=2e-5)
    # S = sum log(1 - alpha): an ulp of alpha near the 0.99 cap moves
    # log(1 - alpha) by ~100 ulps, and S reaches ~-100 under deep overlap
    np.testing.assert_allclose(np.asarray(out[:, 3]), np.asarray(ref[:, 3]),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cap_hit", [False, True], ids=["no_cap", "cap_hit"])
@pytest.mark.parametrize("block", [16, 128])
def test_kernel_vjp_matches_autodiff(rng, block, cap_hit):
    """The hand-derived replay backward against jax.grad of the XLA blend,
    for all nine columns.  With cap_hit, every other Gaussian's raw alpha
    exceeds 0.99 near its center: both sides pass the cap's gradient
    straight through."""
    cols = _cols(rng, 4, block, "dense", cap_hit=cap_hit)
    assert bool((np.asarray(cols[5]) > CONSTS[2]).any()) == cap_hit
    g = jnp.asarray(rng.normal(size=(4, 4, 256)).astype(np.float32))
    grads_k = jax.grad(
        lambda *cs: jnp.sum(block_blend_cols(*cs, CONSTS, True) * g),
        argnums=tuple(range(9)),
    )(*cols)
    grads_r = jax.grad(
        lambda *cs: jnp.sum(_xla_blend(cs) * g), argnums=tuple(range(9))
    )(*cols)
    for name, gk, gr in zip(NAMES, grads_k, grads_r):
        gk, gr = np.asarray(gk), np.asarray(gr)
        assert np.isfinite(gk).all(), name
        rel = np.abs(gk - gr).max() / (np.abs(gr).max() + 1e-12)
        assert rel < 1e-4, (name, rel)


def test_forward_image_matches_xla(rng, blend_interpret):
    params = _params(rng)
    cam = make_camera_for_scene(width=64, height=48)
    cfg_x, cfg_p = _cfgs()
    img_x, aux_x = jax.jit(render, static_argnums=2)(params, cam, cfg_x)
    assert not blend_interpret
    img_p, aux_p = jax.jit(render, static_argnums=2)(params, cam, cfg_p)
    assert blend_interpret                             # the kernel ran
    np.testing.assert_allclose(np.asarray(img_x), np.asarray(img_p), atol=2e-5)
    assert int(aux_x.num_pairs) == int(aux_p.num_pairs)


def test_gradients_match_xla(rng, blend_interpret):
    params = _params(rng)
    cam = make_camera_for_scene(width=64, height=48)
    cfg_x, cfg_p = _cfgs()
    weights = jnp.asarray(
        rng.uniform(0.5, 1.0, (48, 64, 3)).astype(np.float32)
    )

    def loss(p, cfg):
        img, _ = render(p, cam, cfg)
        return jnp.sum(img * weights)

    gx = jax.jit(jax.grad(loss, allow_int=True), static_argnums=1)(params, cfg_x)
    gp = jax.jit(jax.grad(loss, allow_int=True), static_argnums=1)(params, cfg_p)
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        a, b = np.asarray(getattr(gx, f)), np.asarray(getattr(gp, f))
        rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-12)
        assert rel < 1e-4, f"{f}: rel diff {rel}"


def test_block_blend_vjp_matches_autodiff(rng):
    """Direct unit check of the kernel pair at tile_size 8 on random column
    data: forward and all nine column gradients against the XLA blend.
    (FD checks are unusable here: a perturbation can flip the
    alpha-floor/power-window masks, a step both implementations
    deliberately treat as constant, matching tiled_shaders.metal:350-356.)"""
    nb, b, ts = 5, 16, 8
    consts = (ts,) + CONSTS[1:]

    def arr(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, (nb, b)).astype(np.float32))

    cols = (arr(-3.0, 3.0), arr(-3.0, 3.0), arr(0.05, 0.4), arr(-0.02, 0.02),
            arr(0.05, 0.4), arr(0.05, 0.95), arr(0, 1), arr(0, 1), arr(0, 1))
    out = block_blend_cols(*cols, consts, True)
    assert out.shape == (nb, 4, ts * ts)
    assert float(jnp.max(jnp.abs(out[:, :3, :]))) > 0.0
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(_xla_blend(cols, consts)), atol=2e-5)

    g = jnp.asarray(rng.normal(size=out.shape).astype(np.float32))
    grads_k = jax.grad(
        lambda *cs: jnp.sum(block_blend_cols(*cs, consts, True) * g),
        argnums=tuple(range(9)),
    )(*cols)
    grads_r = jax.grad(
        lambda *cs: jnp.sum(_xla_blend(cs, consts) * g),
        argnums=tuple(range(9)),
    )(*cols)
    for name, gk, gr in zip(NAMES, grads_k, grads_r):
        a_, b_ = np.asarray(gk), np.asarray(gr)
        rel = np.abs(a_ - b_).max() / (np.abs(b_).max() + 1e-12)
        assert rel < 1e-4, (name, rel)


def test_auto_picks_xla_off_gpu():
    assert jax.default_backend() != "gpu"
    assert rasterize._use_kernel("auto") is False
    assert rasterize._use_kernel("xla") is False
    # interpret mode is no config value: only tests pass interpret=True
    for impl in ("pallas", "pallas_interpret", "cuda"):
        with pytest.raises(ValueError, match="unknown blend_impl"):
            rasterize._use_kernel(impl)


def test_kernel_off_gpu_without_interpret_raises(rng, monkeypatch):
    cols = _cols(rng, 2, 16, "sparse")
    with pytest.raises(ValueError, match="GPU only"):
        block_blend_cols(*cols, CONSTS)
    # the renderer never asks for the interpreter: routed to the kernel off
    # the GPU, it raises instead of silently interpreting
    params = _params(rng)
    cam = make_camera_for_scene(width=32, height=32)
    monkeypatch.setattr(rasterize, "_use_kernel", lambda impl: True)
    jax.clear_caches()
    with pytest.raises(ValueError, match="GPU only"):
        jax.jit(render, static_argnums=2)(params, cam, _cfgs()[1])
    jax.clear_caches()


def test_kernel_rejects_non_power_of_two_block(rng):
    cols = _cols(rng, 2, 24, "sparse")
    with pytest.raises(ValueError, match="power-of-two pair_block"):
        block_blend_cols(*cols, CONSTS, True)


@pytest.mark.gpu
@pytest.mark.parametrize("cap_hit", [False, True], ids=["no_cap", "cap_hit"])
@pytest.mark.parametrize("block", [32, 128])
def test_compiled_kernel_matches_xla(rng, block, cap_hit):
    """The kernels compiled for the card, forward and VJP, against the XLA
    blend on the same device at full f32 matmul precision."""
    cols = _cols(rng, 64, block, "dense", cap_hit=cap_hit)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda *c: block_blend_cols(*c, CONSTS))(*cols)
        ref = jax.jit(_xla_blend)(cols)
        g = jnp.asarray(rng.normal(size=out.shape).astype(np.float32))
        gk = jax.jit(jax.grad(
            lambda *cs: jnp.sum(block_blend_cols(*cs, CONSTS) * g),
            argnums=tuple(range(9))))(*cols)
        gr = jax.jit(jax.grad(
            lambda *cs: jnp.sum(_xla_blend(cs) * g),
            argnums=tuple(range(9))))(*cols)
    np.testing.assert_allclose(np.asarray(out[:, :3]), np.asarray(ref[:, :3]),
                               atol=1e-4)
    for name, a, b in zip(NAMES, gk, gr):
        a, b = np.asarray(a), np.asarray(b)
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)
        assert rel < 1e-3, (name, rel)


@pytest.mark.gpu
def test_compiled_render_matches_xla(rng):
    params = _params(rng, n=512)
    cam = make_camera_for_scene(width=128, height=96)
    cfg_x, cfg_p = _cfgs()
    img_x, _ = jax.jit(render, static_argnums=2)(params, cam, cfg_x)
    img_p, _ = jax.jit(render, static_argnums=2)(params, cam, cfg_p)
    np.testing.assert_allclose(np.asarray(img_x), np.asarray(img_p), atol=1e-4)
