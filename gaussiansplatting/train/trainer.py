"""Training loop: one fully jitted, device-resident train step plus the Python
orchestration of the densify / opacity-reset schedule.

The reference's per-image trainStep issues >=6 separate GPU command buffers
with a CPU sync after each (mtl_engine.mm:856-1025, SURVEY.md §3.2: forward,
loss, backward, accumulate, Adam, plus CPU sorting in between).  Here the
whole thing — render, loss, gradient, Adam, density accumulation — is ONE
jitted function with zero host syncs; densification and opacity resets are
separate jitted events triggered on the reference's schedule
(mtl_engine.mm:1047-1221).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussiansplatting.config import Config
from gaussiansplatting.core.camera import Camera
from gaussiansplatting.density import control as density
from gaussiansplatting.ops.losses import photometric_loss, psnr
from gaussiansplatting.ops.rasterize import render
from gaussiansplatting.train import optimizer, schedule
from gaussiansplatting.train.state import TrainState


class StepMetrics(NamedTuple):
    loss: jnp.ndarray        # combined (1-l)L1 + l*DSSIM per-pixel mean
    l1: jnp.ndarray
    dssim: jnp.ndarray
    psnr: jnp.ndarray
    num_pairs: jnp.ndarray
    overflow: jnp.ndarray
    position_lr: jnp.ndarray
    num_gaussians: jnp.ndarray
    # population statistics (reference: per-200-step opacity/scale sample
    # dump, mtl_engine.mm:1009-1022)
    mean_opacity: jnp.ndarray
    mean_world_scale: jnp.ndarray


def _train_step_impl(
    state: TrainState,
    camera: Camera,
    gt_image: jnp.ndarray,
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """One optimization step on one view (reference: trainStep,
    mtl_engine.mm:856-1025)."""
    params = state.params
    capacity = params.capacity

    def loss_fn(trainable, vs_dummy):
        p = params.replace(**trainable)
        img, aux = render(p, camera, cfg.raster, vs_dummy=vs_dummy)
        rep = photometric_loss(img, gt_image, cfg.loss)
        return rep.grad_loss, (rep, aux, img)

    trainable = {f: getattr(params, f) for f in optimizer.TRAINABLE}
    vs_zero = jnp.zeros((capacity, 2), jnp.float32)
    (_, (rep, aux, img)), (grads, vs_grad) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True
    )(trainable, vs_zero)

    # LR uses the pre-increment iteration count (mtl_engine.mm:1092-1094)
    lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = optimizer.step(params, grads, state.opt, lrs, cfg.optim)

    # density statistics (reference: DensityController::accumulateGradients
    # after every backward, mtl_engine.mm:1000-1002)
    new_accum = density.accumulate(state.accum, vs_grad, grads["means"], cfg.density)

    metrics = StepMetrics(
        loss=rep.combined_mean,
        l1=rep.l1_mean,
        dssim=rep.dssim_mean,
        psnr=psnr(img, gt_image),
        num_pairs=aux.num_pairs,
        overflow=aux.overflow,
        position_lr=lrs.position,
        num_gaussians=new_params.count(),
        mean_opacity=_mean_opacity(new_params),
        mean_world_scale=_mean_world_scale(new_params),
    )
    new_state = state.replace(params=new_params, opt=new_opt, accum=new_accum)
    return new_state, metrics


train_step = jax.jit(_train_step_impl, static_argnames=("cfg", "total_iters"))


@functools.partial(
    jax.jit, static_argnames=("cfg", "total_iters"), donate_argnums=(0,)
)
def train_steps(
    state: TrainState,
    cameras: Camera,          # K-stacked camera pytree (same static W/H)
    gt_images: jnp.ndarray,   # [K, H, W, 3]
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """K SEQUENTIAL optimization steps in ONE compiled program.

    Semantically identical to K train_step calls (one Adam step per view,
    ``lax.scan`` threads the state), but dispatched as a single device
    program: per-step host dispatch latency is paid once per K steps
    instead of per step.  The reference's loop pays >=6 blocking
    command-buffer syncs per step (SURVEY.md §3.2); this is the opposite
    extreme.  State buffers are donated (the old state is consumed).

    Returns (state, metrics) with every StepMetrics field stacked [K].
    """

    def body(st, view):
        cam, gt = view
        return _train_step_impl(st, cam, gt, cfg, total_iters)

    return jax.lax.scan(body, state, (cameras, gt_images))


def _mean_opacity(params) -> jnp.ndarray:
    import gaussiansplatting.core.transforms as T

    alive = params.alive.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(alive), 1.0)
    return jnp.sum(T.sigmoid(params.raw_opacities) * alive) / n


def _mean_world_scale(params) -> jnp.ndarray:
    alive = params.alive.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(alive), 1.0)
    max_scale = jnp.max(jnp.exp(jnp.clip(params.log_scales, -8.0, 8.0)), axis=-1)
    return jnp.sum(max_scale * alive) / n


@functools.partial(jax.jit, static_argnames=("cfg", "total_iters"))
def train_step_batched(
    state: TrainState,
    cameras: Camera,          # K-stacked pytree (same static W/H)
    gt_images: jnp.ndarray,   # [K, H, W, 3]
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """One Adam step on the MEAN loss over K views (gradient accumulation).

    No reference equivalent — the reference (and official 3DGS) steps per
    view.  The value is the larger effective batch (smoother gradients), not
    throughput: per-view work is dominated by capacity-proportional index ops
    that K-fold batching multiplies rather than amortizes.  Density
    statistics accumulate per view exactly as K sequential accumulate()
    calls would at the same parameters (density_control.mm:121-185): per-view position gradients are
    recovered through a per-view zero ``pos_dummy`` added to the means (the
    mean-loss gradient w.r.t. the shared means would blur the per-view
    ``contrib`` gating otherwise).

    ``metrics.num_pairs`` reports the MAX per-view pair count — the quantity
    pair capacity must cover — not the K-view sum.
    """
    params = state.params
    capacity = params.capacity
    k = gt_images.shape[0]

    def loss_fn(trainable, vs_dummy, pos_dummy):
        p = params.replace(**trainable)

        def one_view(cam, gt, vs, pos_d):
            pv = p.replace(means=p.means + pos_d)
            img, aux = render(pv, cam, cfg.raster, vs_dummy=vs)
            rep = photometric_loss(img, gt, cfg.loss)
            return rep, aux, img

        rep, aux, imgs = jax.vmap(one_view, in_axes=(0, 0, 0, 0))(
            cameras, gt_images, vs_dummy, pos_dummy
        )
        return jnp.mean(rep.grad_loss), (rep, aux, imgs)

    trainable = {f: getattr(params, f) for f in optimizer.TRAINABLE}
    vs_zero = jnp.zeros((k, capacity, 2), jnp.float32)
    pos_zero = jnp.zeros((k, capacity, 3), jnp.float32)
    (_, (rep, aux, imgs)), (grads, vs_grad, pos_grad) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True
    )(trainable, vs_zero, pos_zero)

    lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = optimizer.step(params, grads, state.opt, lrs, cfg.optim)

    # per-view density statistics: fold K views sequentially (the vs_grad /
    # pos_grad of the mean loss are each view's gradient / K; undo the 1/K so
    # thresholds keep their reference meaning)
    accum = state.accum

    def fold(accum, view):
        vsg, pg = view
        return density.accumulate(accum, vsg * k, pg * k, cfg.density), None

    accum, _ = jax.lax.scan(fold, accum, (vs_grad, pos_grad))

    metrics = StepMetrics(
        loss=jnp.mean(rep.combined_mean),
        l1=jnp.mean(rep.l1_mean),
        dssim=jnp.mean(rep.dssim_mean),
        psnr=jnp.mean(psnr(imgs, gt_images)),
        num_pairs=jnp.max(aux.num_pairs),
        overflow=jnp.any(aux.overflow),
        position_lr=lrs.position,
        num_gaussians=new_params.count(),
        mean_opacity=_mean_opacity(new_params),
        mean_world_scale=_mean_world_scale(new_params),
    )
    return state.replace(params=new_params, opt=new_opt, accum=accum), metrics


@functools.partial(jax.jit, static_argnames=("cfg",))
def densify_step(
    state: TrainState,
    scene_extent: float,
    focal: jnp.ndarray,
    cfg: Config,
) -> tuple[TrainState, density.DensityStats]:
    """One density-control event (mtl_engine.mm:1105-1168)."""
    key, sub = jax.random.split(state.key)
    avg_depth = 2.0 * scene_extent  # conservative (mtl_engine.mm:1128)
    params, opt, accum, stats = density.apply(
        state.params,
        state.opt,
        state.accum,
        state.opt.t,
        sub,
        scene_extent,
        focal,
        avg_depth,
        cfg.density,
    )
    return state.replace(params=params, opt=opt, accum=accum, key=key), stats


@functools.partial(jax.jit, static_argnames=("cfg",))
def opacity_reset_step(state: TrainState, cfg: Config) -> TrainState:
    """Clamp raw opacities to min(op, reset_value), zero opacity+scale
    momentum, reset density accumulators (mtl_engine.mm:1170-1193)."""
    params = state.params
    new_op = jnp.where(
        params.alive,
        jnp.minimum(params.raw_opacities, cfg.density.opacity_reset_value),
        params.raw_opacities,
    )
    return state.replace(
        params=params.replace(raw_opacities=new_op),
        opt=optimizer.reset_opacity_and_scale_momentum(state.opt),
        accum=density.init_accum(params.capacity),
    )


def should_densify(iteration: int, cfg: Config) -> bool:
    """iteration > from AND < until AND % interval == 0 (mtl_engine.mm:1112-1115)."""
    d = cfg.density
    return (
        iteration > d.densify_from_iter
        and iteration < d.densify_until_iter
        and iteration % d.densify_interval == 0
    )


def should_reset_opacity(iteration: int, cfg: Config) -> bool:
    """% 3000 == 0, > 0, < densify_until (mtl_engine.mm:1173-1176)."""
    d = cfg.density
    return (
        iteration > 0
        and iteration % d.opacity_reset_interval == 0
        and iteration < d.densify_until_iter
    )


def _steps_until_event(iteration, cfg, adaptive_pairs, adapt_interval,
                       ckpt_interval, snap_interval):
    """Largest k such that no schedule event fires strictly inside
    (iteration, iteration + k) — an event exactly at the chunk end is fine
    (the loop handles it after the scanned steps return)."""
    d = cfg.density

    def next_mult(interval):
        return interval * (iteration // interval + 1) - iteration

    gaps = []
    j = iteration + next_mult(d.densify_interval)
    while j <= d.densify_from_iter:
        j += d.densify_interval
    if j < d.densify_until_iter:
        gaps.append(j - iteration)
    j = iteration + next_mult(d.opacity_reset_interval)
    if j < d.densify_until_iter:
        gaps.append(j - iteration)
    if adaptive_pairs:
        gaps.append(next_mult(adapt_interval))
    if ckpt_interval:
        gaps.append(next_mult(ckpt_interval))
    if snap_interval:
        gaps.append(next_mult(snap_interval))
    return min(gaps) if gaps else 1 << 30


def train_loop(
    state: TrainState,
    cameras: list[Camera],
    gt_images: list[jnp.ndarray],
    cfg: Config,
    scene_extent: float,
    num_epochs: int | None = None,
    log_fn=None,
    metrics_fn=None,
    checkpoint_fn=None,
    checkpoint_interval: int = 0,
    mesh_devices: int = 1,
    snapshot_fn=None,
    shuffle_seed: int | None = None,
    batch_views: int = 1,
    adaptive_pairs: bool = False,
    adapt_interval: int = 50,
    min_pair_capacity: int = 1 << 16,
    adaptive_capacity: bool = False,
    max_capacity: int | None = None,
    scan_steps: int = 1,
) -> TrainState:
    """Epochs x views, densify/reset on schedule (mtl_engine.mm:1047-1221).

    metrics_fn(iteration, StepMetrics) fires every step; checkpoint_fn
    (iteration, state) every ``checkpoint_interval`` iters; snapshot_fn
    (iteration, state, camera, gt) every cfg.train.snapshot_interval iters
    (reference: per-500-step PPM dumps, mtl_engine.mm:976-988);
    ``mesh_devices`` > 1 shards tile rows across devices (parallel/sharded.py);
    ``shuffle_seed`` randomizes view order per epoch (official-3DGS style —
    the reference always iterates in file order, mtl_engine.mm:1085);
    ``batch_views`` > 1 takes one Adam step on the mean gradient of K views
    (train_step_batched) — iteration counts optimizer steps, so the densify /
    reset / LR schedules then see fewer, larger steps.

    ``adaptive_capacity`` grows the Gaussian arrays (params + Adam moments +
    accumulators) to the next power-of-two bucket when a densify event fills
    85% of the current capacity, up to ``max_capacity`` (default: the
    density hard cap) — real scenes start sparse, and projection/optimizer
    work scales with the STATIC capacity.

    ``scan_steps`` > 1 dispatches runs of exactly ``scan_steps`` consecutive
    steps as ONE compiled program (train_steps) whenever no densify / reset /
    checkpoint / snapshot / adapt event falls inside the run — amortizing
    per-step host dispatch.  Pick a value
    dividing the schedule intervals (e.g. 10 or 25 against the reference's
    100/3000 cadence) so chunks tile the schedule exactly; off-cadence
    positions fall back to single steps.  Only the plain single-view path
    scans (mesh_devices == 1, batch_views == 1).

    ``adaptive_pairs`` resizes the pair capacity to the workload: every
    ``adapt_interval`` iters the loop reads the emitted pair count and
    rebuckets capacity to the next power of two above 1.5x the recent peak
    (within [min_pair_capacity, cfg.raster.pair_capacity]), growing
    immediately on overflow.  Step cost scales with the STATIC
    capacity, not the live pair count, so real scenes — which start sparse
    and densify over time — avoid paying peak cost from iteration 0.  Each
    rebucket triggers one recompile; power-of-two bucketing bounds the
    number of distinct programs to ~log2(max/min).
    """
    epochs = num_epochs if num_epochs is not None else cfg.train.epochs
    steps_per_epoch = -(-len(cameras) // batch_views)
    total_iters = epochs * steps_per_epoch
    iteration = int(state.opt.t)

    max_pair_capacity = cfg.raster.pair_capacity
    if adaptive_pairs:
        cap = min(max_pair_capacity, max(min_pair_capacity, 1))
        cfg = cfg.replace(raster=cfg.raster.replace(pair_capacity=cap))
    recent_peak = 0

    def build_step_fn(cfg):
        if mesh_devices > 1:
            from gaussiansplatting.parallel import mesh as mesh_mod
            from gaussiansplatting.parallel.sharded import (
                make_sharded_train_step,
                make_sharded_train_step_batched,
            )

            if batch_views > 1:
                sharded_step = make_sharded_train_step_batched(
                    mesh_mod.make_mesh(mesh_devices), cfg, total_iters,
                    batch_views,
                )
            else:
                sharded_step = make_sharded_train_step(
                    mesh_mod.make_mesh(mesh_devices), cfg, total_iters
                )
            return lambda st, cam, gt: sharded_step(st, cam, gt)
        if batch_views > 1:
            return lambda st, cam, gt: train_step_batched(
                st, cam, gt, cfg, total_iters
            )
        return lambda st, cam, gt: train_step(st, cam, gt, cfg, total_iters)

    step_fn = build_step_fn(cfg)

    import random as _random

    order_rng = _random.Random(shuffle_seed) if shuffle_seed is not None else None

    if batch_views > 1 or scan_steps > 1:
        sizes = {(c.width, c.height) for c in cameras}
        if len(sizes) > 1:
            which = "batch_views" if batch_views > 1 else "scan_steps"
            raise ValueError(f"{which} requires one resolution, got {sizes}")

    for epoch in range(epochs):
        order = list(range(len(cameras)))
        if order_rng is not None:
            order_rng.shuffle(order)
        if batch_views > 1:
            groups = [
                [order[(i + j) % len(order)] for j in range(batch_views)]
                for i in range(0, len(order), batch_views)
            ]
            # (stacked camera pytree, stacked gt, first view's camera + gt —
            # densify needs a scalar focal and snapshot_fn a single view)
            views_iter = [
                (
                    jax.tree_util.tree_map(
                        lambda *xs: jnp.stack(xs), *[cameras[v] for v in g]
                    ),
                    jnp.stack([gt_images[v] for v in g]),
                    cameras[g[0]],
                    gt_images[g[0]],
                )
                for g in groups
            ]
        else:
            views_iter = [
                (cameras[v], gt_images[v], cameras[v], gt_images[v])
                for v in order
            ]
        use_scan = scan_steps > 1 and mesh_devices == 1 and batch_views == 1
        idx = 0
        while idx < len(views_iter):
            k = 1
            if use_scan and idx + scan_steps <= len(views_iter):
                gap = _steps_until_event(
                    iteration, cfg, adaptive_pairs, adapt_interval,
                    checkpoint_interval if checkpoint_fn else 0,
                    cfg.train.snapshot_interval if snapshot_fn else 0,
                )
                if gap >= scan_steps:
                    k = scan_steps
            if k > 1:
                chunk = views_iter[idx:idx + k]
                cams_k = jax.tree_util.tree_map(
                    lambda *xs: jnp.stack(xs), *[c[0] for c in chunk]
                )
                gts_k = jnp.stack([c[1] for c in chunk])
                state, ms = train_steps(state, cams_k, gts_k, cfg, total_iters)
                for i in range(k):
                    iteration += 1
                    if metrics_fn:
                        metrics_fn(
                            iteration,
                            jax.tree_util.tree_map(lambda x, i=i: x[i], ms),
                        )
                metrics = jax.tree_util.tree_map(lambda x: x[-1], ms)
            else:
                cam, gt, _, _ = views_iter[idx]
                state, metrics = step_fn(state, cam, gt)
                iteration += 1
                if metrics_fn:
                    metrics_fn(iteration, metrics)
            cam0, gt0 = views_iter[idx + k - 1][2], views_iter[idx + k - 1][3]
            idx += k

            if adaptive_pairs and iteration % adapt_interval == 0:
                pairs_now = int(metrics.num_pairs)
                recent_peak = max(recent_peak, pairs_now)
                cur = cfg.raster.pair_capacity
                if bool(metrics.overflow):
                    want = min(cur * 2, max_pair_capacity)
                else:
                    want = 1 << max(int(recent_peak * 1.5) - 1, 1).bit_length()
                    want = min(max(want, min_pair_capacity), max_pair_capacity)
                if want != cur:
                    cfg = cfg.replace(
                        raster=cfg.raster.replace(pair_capacity=want)
                    )
                    step_fn = build_step_fn(cfg)
                    recent_peak = pairs_now
                    if log_fn:
                        log_fn(
                            f"iter {iteration}: pair capacity {cur} -> {want} "
                            f"(live pairs {pairs_now})"
                        )
            if checkpoint_fn and checkpoint_interval and iteration % checkpoint_interval == 0:
                checkpoint_fn(iteration, state)
            if (
                snapshot_fn
                and cfg.train.snapshot_interval
                and iteration % cfg.train.snapshot_interval == 0
            ):
                snapshot_fn(iteration, state, cam0, gt0)

            if should_densify(iteration, cfg):
                state, stats = densify_step(state, scene_extent, cam0.fx, cfg)
                if log_fn:
                    log_fn(
                        f"iter {iteration}: densify pruned={int(stats.pruned)} "
                        f"cloned={int(stats.cloned)} split={int(stats.split)} "
                        f"total={int(stats.count)}"
                    )
                if adaptive_capacity:
                    # grow the state to the next capacity bucket when the
                    # population nears the arrays' end — the counterpart of
                    # the reference's buffer reallocation on densify
                    # (density_control.mm:385-490); each bucket compiles
                    # its own train/densify programs once
                    from gaussiansplatting.train import state as state_mod

                    cap = state.params.capacity
                    limit = int(max_capacity or cfg.density.max_gaussians)
                    if int(stats.count) >= int(0.85 * cap) and cap < limit:
                        new_cap = min(cap * 2, limit)
                        state = state_mod.grow(state, new_cap)
                        if log_fn:
                            log_fn(
                                f"iter {iteration}: capacity {cap} -> {new_cap}"
                            )
            if should_reset_opacity(iteration, cfg):
                state = opacity_reset_step(state, cfg)
                if log_fn:
                    log_fn(f"iter {iteration}: opacity reset")

            if log_fn and (idx - k) % cfg.train.log_interval == 0:
                log_fn(
                    f"epoch {epoch} [{idx}/{len(cameras)}] "
                    f"loss={float(metrics.loss):.4f} psnr={float(metrics.psnr):.2f} "
                    f"n={int(metrics.num_gaussians)} pairs={int(metrics.num_pairs)}"
                )
    return state
