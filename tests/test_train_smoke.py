"""End-to-end single-chip training smoke test (BASELINE config #3 analog):
render a fixed synthetic 'ground truth' scene, start from perturbed parameters,
and verify the loss decreases and PSNR improves over a handful of steps."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gaussiansplatting.config import (
    Config, DensityConfig, LossConfig, OptimConfig, RasterConfig, TrainConfig,
)
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.train import state as train_state
from gaussiansplatting.train import trainer

from conftest import make_camera_for_scene, make_scene


def _cfg():
    return Config(
        raster=RasterConfig(pair_capacity=2048, pair_block=16),
        optim=OptimConfig(
            position_lr_init=2e-3, position_lr_final=2e-4,
            scale_lr=5e-3, rotation_lr=1e-3, opacity_lr=0.05, sh_lr=0.01,
        ),
        loss=LossConfig(),
        density=DensityConfig(),
        train=TrainConfig(),
    )


def _scene_params(rng, n=32, perturb=0.0, capacity=None):
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    if perturb:
        r2 = np.random.default_rng(7)
        sh_dc = sh_dc + r2.normal(0, perturb, sh_dc.shape).astype(np.float32)
        raw_op = raw_op + r2.normal(0, perturb, raw_op.shape).astype(np.float32)
        means = means + r2.normal(0, perturb * 0.05, means.shape).astype(np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return G.from_arrays(means, log_scales, quats, raw_op, sh, capacity=capacity)


def test_training_reduces_loss(rng):
    from gaussiansplatting.ops.rasterize import render

    cfg = _cfg()
    cam = make_camera_for_scene(width=48, height=32)
    gt_params = _scene_params(rng, perturb=0.0)
    gt_img, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)
    gt_img = jax.lax.stop_gradient(gt_img)

    st = train_state.create(_scene_params(rng, perturb=0.8))
    losses, psnrs = [], []
    for _ in range(30):
        st, metrics = trainer.train_step(st, cam, gt_img, cfg, total_iters=1000)
        losses.append(float(metrics.loss))
        psnrs.append(float(metrics.psnr))

    assert int(st.opt.t) == 30
    assert losses[-1] < losses[0] * 0.7, f"loss did not decrease: {losses[:3]} -> {losses[-3:]}"
    assert psnrs[-1] > psnrs[0] + 1.0, f"psnr did not improve: {psnrs[0]} -> {psnrs[-1]}"
    assert not bool(metrics.overflow)


@pytest.mark.slow
def test_train_loop_with_densify_and_reset(rng):
    """Exercise the full schedule machinery on a tiny run (intervals shrunk)."""
    cfg = _cfg().replace(
        density=DensityConfig(
            densify_from_iter=2, densify_until_iter=100, densify_interval=5,
            opacity_reset_interval=12, grad_threshold=1e-9,  # force activity
        ),
    )
    cam = make_camera_for_scene(width=32, height=32)
    gt_params = _scene_params(rng, n=16)
    from gaussiansplatting.ops.rasterize import render

    gt_img, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st = train_state.create(_scene_params(rng, n=16, perturb=0.5, capacity=64))
    logs = []
    st = trainer.train_loop(
        st, [cam], [gt_img], cfg, scene_extent=5.0, num_epochs=15,
        log_fn=logs.append,
    )
    assert int(st.opt.t) == 15
    assert any("densify" in l for l in logs), logs
    assert any("opacity reset" in l for l in logs), logs
    # population stays within capacity and alive mask is a prefix
    alive = np.asarray(st.params.alive)
    n = alive.sum()
    assert alive[:n].all() and not alive[n:].any()
    # opacity reset clamped raw opacities of live gaussians
    assert float(st.params.raw_opacities[alive].max()) <= 8.0


def test_schedule_predicates():
    cfg = Config()
    assert not trainer.should_densify(500, cfg)    # strict >
    assert trainer.should_densify(600, cfg)
    assert not trainer.should_densify(650, cfg)    # interval
    assert not trainer.should_densify(15000, cfg)  # strict <
    assert trainer.should_reset_opacity(3000, cfg)
    assert not trainer.should_reset_opacity(0, cfg)
    assert not trainer.should_reset_opacity(15000, cfg)
    assert not trainer.should_reset_opacity(3001, cfg)


@pytest.mark.slow
def test_batched_step_matches_mean_gradient(rng):
    """train_step_batched over K views == one Adam step on the mean of the
    per-view gradients (gradient accumulation semantics)."""
    import jax

    from gaussiansplatting.ops.losses import photometric_loss
    from gaussiansplatting.ops.rasterize import render
    from gaussiansplatting.train import optimizer, schedule

    cfg = _cfg()
    cams = [
        make_camera_for_scene(width=48, height=32),
        make_camera_for_scene(width=48, height=32, fov_scale=1.5),
    ]
    gt_params = _scene_params(rng)
    gts = [
        jax.jit(render, static_argnums=2)(gt_params, c, cfg.raster)[0]
        for c in cams
    ]

    start = _scene_params(rng, perturb=0.5)
    st = train_state.create(start)

    # manual: mean of per-view grads -> one optimizer.step
    def view_loss(trainable, cam, gt):
        p = start.replace(**trainable)
        img, _ = render(p, cam, cfg.raster)
        return photometric_loss(img, gt, cfg.loss).grad_loss

    trainable = {f: getattr(start, f) for f in optimizer.TRAINABLE}
    g0 = jax.grad(view_loss)(trainable, cams[0], gts[0])
    g1 = jax.grad(view_loss)(trainable, cams[1], gts[1])
    mean_g = {k: (g0[k] + g1[k]) / 2.0 for k in g0}
    lrs = schedule.learning_rates(cfg.optim, st.opt.t, 100)
    want_params, _ = optimizer.step(start, mean_g, st.opt, lrs, cfg.optim)

    cam_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    gt_batch = jnp.stack(gts)
    new_st, metrics = trainer.train_step_batched(st, cam_batch, gt_batch, cfg, 100)

    np.testing.assert_allclose(
        np.asarray(new_st.params.means), np.asarray(want_params.means), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(new_st.params.sh), np.asarray(want_params.sh), atol=1e-6
    )
    assert int(new_st.opt.t) == 1
    # density accumulators saw both views
    single_st, _ = trainer.train_step(st, cams[0], gts[0], cfg, 100)
    assert float(jnp.sum(new_st.accum.grad_count)) >= float(
        jnp.sum(single_st.accum.grad_count)
    )


def test_batched_pos_grad_accum_matches_sequential(rng):
    """K-batched density accumulation == K sequential accumulate() calls at
    the same parameters — including the PER-VIEW position gradients gating
    (reference: density_control.mm:121-185).  Round-1 bug: the batched step
    broadcast the K-view MEAN position gradient into every view's fold."""
    import jax

    from gaussiansplatting.density import control as density
    from gaussiansplatting.ops.losses import photometric_loss
    from gaussiansplatting.ops.rasterize import render

    cfg = _cfg()
    cams = [
        make_camera_for_scene(width=48, height=32),
        make_camera_for_scene(width=48, height=32, fov_scale=1.5),
    ]
    gt_params = _scene_params(rng)
    gts = [
        jax.jit(render, static_argnums=2)(gt_params, c, cfg.raster)[0]
        for c in cams
    ]
    start = _scene_params(rng, perturb=0.5)
    st = train_state.create(start)

    # sequential reference: per-view grads at the SAME params
    def view_loss(means, vs, cam, gt):
        p = start.replace(means=means)
        img, _ = render(p, cam, cfg.raster, vs_dummy=vs)
        return photometric_loss(img, gt, cfg.loss).grad_loss

    vs0 = jnp.zeros((start.capacity, 2), jnp.float32)
    accum = density.init_accum(start.capacity)
    for cam, gt in zip(cams, gts):
        pg, vsg = jax.grad(view_loss, argnums=(0, 1))(start.means, vs0, cam, gt)
        accum = density.accumulate(accum, vsg, pg, cfg.density)

    cam_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    new_st, _ = trainer.train_step_batched(st, cam_batch, jnp.stack(gts), cfg, 100)

    np.testing.assert_array_equal(
        np.asarray(new_st.accum.grad_count), np.asarray(accum.grad_count)
    )
    # fp32-only differences: batched takes grads of mean-loss*K, sequential
    # per-view — same math, different reduction order
    np.testing.assert_allclose(
        np.asarray(new_st.accum.grad_accum), np.asarray(accum.grad_accum),
        rtol=2e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(new_st.accum.pos_grad_accum),
        np.asarray(accum.pos_grad_accum),
        rtol=2e-4, atol=1e-5,
    )


@pytest.mark.slow
def test_train_loop_batched_crosses_densify(rng, tmp_path):
    """train_loop with batch_views>1 must survive densify events, opacity
    resets, and snapshots (round-1 bug: the stacked camera pytree reached
    densify_step's scalar-focal path and snapshot_fn)."""
    import jax
    from gaussiansplatting.ops.rasterize import render

    cfg = _cfg().replace(
        density=DensityConfig(
            densify_from_iter=1, densify_until_iter=100, densify_interval=3,
            opacity_reset_interval=8, grad_threshold=1e-9,
        ),
        train=TrainConfig(snapshot_interval=4),
    )
    cams = [
        make_camera_for_scene(width=32, height=32),
        make_camera_for_scene(width=32, height=32, fov_scale=1.4),
        make_camera_for_scene(width=32, height=32, fov_scale=0.8),
    ]
    gt_params = _scene_params(rng, n=16)
    gts = [
        jax.jit(render, static_argnums=2)(gt_params, c, cfg.raster)[0]
        for c in cams
    ]
    st = train_state.create(_scene_params(rng, n=16, perturb=0.5, capacity=64))
    logs, snaps = [], []

    def snapshot_fn(iteration, state, cam, gt):
        # must be a single view: render it to prove the camera is consumable
        img, _ = jax.jit(render, static_argnums=2)(state.params, cam, cfg.raster)
        assert img.shape == gt.shape
        snaps.append(iteration)

    st = trainer.train_loop(
        st, cams, gts, cfg, scene_extent=5.0, num_epochs=6,
        batch_views=2, log_fn=logs.append, snapshot_fn=snapshot_fn,
        adaptive_pairs=True, adapt_interval=1, min_pair_capacity=256,
    )
    # 3 views / batch 2 -> 2 steps per epoch
    assert int(st.opt.t) == 12
    assert any("densify" in l for l in logs), logs
    assert any("opacity reset" in l for l in logs), logs
    assert snaps == [4, 8, 12]
    alive = np.asarray(st.params.alive)
    n = alive.sum()
    assert alive[:n].all() and not alive[n:].any()


@pytest.mark.slow
def test_adaptive_pair_capacity_grows_out_of_overflow(rng):
    """Starting below the live pair count, the loop doubles capacity until
    pairs fit (power-of-two buckets, bounded by the configured maximum)."""
    import jax
    from gaussiansplatting.ops.rasterize import render

    cfg = _cfg().replace(
        raster=RasterConfig(pair_capacity=1 << 14, pair_block=16),
    )
    cam = make_camera_for_scene(width=48, height=32)
    gt_params = _scene_params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st = train_state.create(_scene_params(rng, perturb=0.5))
    logs = []
    # the scene emits ~90 pairs; start the bucket at 64 to force overflow
    st = trainer.train_loop(
        st, [cam], [gt], cfg, scene_extent=1.0, num_epochs=8,
        adaptive_pairs=True, adapt_interval=1, min_pair_capacity=64,
        log_fn=logs.append,
    )
    assert int(st.opt.t) == 8
    resizes = [l for l in logs if "pair capacity" in l]
    assert resizes, logs
    assert "64 -> 128" in resizes[0]
    # after growth the final steps must not overflow
    last_pairs = [l for l in logs if "pairs=" in l][-1]
    assert "pairs=9" in last_pairs or "pairs=8" in last_pairs


@pytest.mark.slow
def test_train_loop_adaptive_capacity_grows(rng):
    """Adaptive capacity: when a densify event fills 85% of the arrays, the
    state grows to the next bucket (the counterpart of the reference's
    buffer reallocation, density_control.mm:385-490) and training
    continues with the carried Adam state and accumulators."""
    cfg = _cfg().replace(
        density=DensityConfig(
            densify_from_iter=2, densify_until_iter=100, densify_interval=3,
            opacity_reset_interval=1000, grad_threshold=1e-9,
        ),
    )
    cam = make_camera_for_scene(width=32, height=32)
    gt_params = _scene_params(rng, n=16)
    from gaussiansplatting.ops.rasterize import render

    gt_img, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st = train_state.create(_scene_params(rng, n=16, perturb=0.5, capacity=32))
    logs = []
    st = trainer.train_loop(
        st, [cam], [gt_img], cfg, scene_extent=5.0, num_epochs=12,
        log_fn=logs.append, adaptive_capacity=True, max_capacity=128,
    )
    assert any("capacity 32 -> 64" in l for l in logs), logs
    assert st.params.capacity in (64, 128)
    assert st.opt.m["means"].shape[0] == st.params.capacity
    assert st.accum.grad_accum.shape[0] == st.params.capacity
    assert np.isfinite(float(st.params.means[: int(np.asarray(st.params.alive).sum())].max()))
    alive = np.asarray(st.params.alive)
    n = alive.sum()
    assert alive[:n].all() and not alive[n:].any()


@pytest.mark.slow
def test_scan_steps_loop_matches_single_dispatch(rng):
    """train_loop(scan_steps=3) — chunked lax.scan dispatch with densify /
    reset events interleaved on the reference cadence — produces the same
    training trajectory as the per-step dispatch, and counts iterations
    identically (events land between chunks; off-cadence falls back to
    single steps)."""
    from gaussiansplatting.ops.rasterize import render

    cfg = _cfg().replace(
        density=DensityConfig(
            densify_from_iter=1, densify_until_iter=40, densify_interval=6,
            opacity_reset_interval=14, grad_threshold=1e-9,
        ),
    )
    cam = make_camera_for_scene(width=48, height=32)
    gt_params = _scene_params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    def run(scan_steps):
        st = train_state.create(
            _scene_params(np.random.default_rng(3), capacity=96)
        )
        logs = []
        st = trainer.train_loop(
            st, [cam] * 5, [gt] * 5, cfg, scene_extent=1.0, num_epochs=4,
            scan_steps=scan_steps, log_fn=logs.append,
        )
        return st, logs

    st1, logs1 = run(1)
    st3, logs3 = run(3)
    assert int(st1.opt.t) == int(st3.opt.t) == 20
    # same densify/reset event lines in the same order
    ev1 = [l for l in logs1 if "densify" in l or "reset" in l]
    ev3 = [l for l in logs3 if "densify" in l or "reset" in l]
    assert ev1 == ev3
    # scan vs standalone jit fuse differently, so individual elements can
    # drift by float rounding amplified over 20 steps — semantic
    # equivalence, not bit equality, is the contract here
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        np.testing.assert_allclose(
            np.asarray(getattr(st1.params, f)),
            np.asarray(getattr(st3.params, f)),
            rtol=1e-3, atol=1e-4, err_msg=f,
        )


@pytest.mark.slow
def test_config4_feature_stack_integration(rng, blend_interpret):
    """The feature combination of a reference-scale run at toy scale: the
    Pallas blend (interpret mode here) + scanned dispatch + adaptive pairs +
    adaptive capacity + impact overflow drop + chunk slack, through densify
    and opacity-reset events."""
    from gaussiansplatting.ops.rasterize import render

    cfg = _cfg().replace(
        raster=RasterConfig(
            pair_capacity=1 << 12, pair_block=16,
            blend_impl="auto", overflow_drop="impact",
            chunk_slack=0.5,
        ),
        density=DensityConfig(
            densify_from_iter=1, densify_until_iter=40, densify_interval=4,
            opacity_reset_interval=10, grad_threshold=1e-9,
        ),
    )
    cam = make_camera_for_scene(width=48, height=32)
    gt_params = _scene_params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st = train_state.create(
        _scene_params(np.random.default_rng(3), capacity=64)
    )
    logs = []
    st = trainer.train_loop(
        st, [cam] * 4, [gt] * 4, cfg, scene_extent=1.0, num_epochs=4,
        scan_steps=2, adaptive_pairs=True, adapt_interval=2,
        min_pair_capacity=256, adaptive_capacity=True, max_capacity=256,
        log_fn=logs.append,
    )
    assert int(st.opt.t) == 16
    assert any("densify" in l for l in logs)
    assert np.isfinite(np.asarray(st.params.means)).all()
    assert int(np.asarray(st.params.alive).sum()) > 0
