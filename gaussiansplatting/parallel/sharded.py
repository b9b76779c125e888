"""Tile-sharded multi-chip training step (shard_map over a 1-D device mesh).

Scheme (SURVEY.md §2.3 / §7.1): Gaussian parameters are REPLICATED; each
device rasterizes a horizontal strip of tile rows (the expensive part — the
honest analog of sequence/context parallelism for a rasterizer); strips
all_gather into the full image so the photometric loss (including the 11x11
D-SSIM window across strip boundaries) is computed bit-identically on every
device; autodiff routes each device exactly its own strip's cotangent back
through the all_gather, so per-Gaussian gradients are per-device partial sums
that one psum completes.  The Adam update then runs replicated.

Collectives used: all_gather (strip assembly, forward), psum_scatter (its
transpose, backward — inserted by AD), psum (gradient reduction + metrics).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gaussiansplatting.config import Config
from gaussiansplatting.core.camera import Camera
from gaussiansplatting.density import control as density
from gaussiansplatting.ops import projection as proj_mod
from gaussiansplatting.ops.losses import photometric_loss, psnr
from gaussiansplatting.ops.rasterize import render
from gaussiansplatting.parallel.mesh import TILE_AXIS
from gaussiansplatting.train import optimizer, schedule
from gaussiansplatting.train.state import TrainState
from gaussiansplatting.train.trainer import StepMetrics


def strip_rows(height: int, tile_size: int, num_devices: int) -> int:
    """Tile rows per device (last device may cover padding rows)."""
    tiles_y = proj_mod.num_tiles(height, tile_size)
    return -(-tiles_y // num_devices)


def chunked_psum(grads: dict, axis_name: str, chunks: int) -> dict:
    """Complete per-device partial parameter gradients with CHUNKED psums
    (SURVEY.md §7.5.6: overlap the gradient all-reduce with the tail of the
    backward).  Each parameter group's [capacity, ...] gradient is split
    along the Gaussian axis into `chunks` slices and each slice gets its own
    psum: the XLA latency-hiding scheduler can then launch every slice's
    all-reduce as soon as its cotangent bytes exist instead of waiting for
    the full tensor, and the chunks of different groups interleave with the
    remaining backward compute.  psum is elementwise across the reduced
    axis, so the result is BIT-IDENTICAL to the single psum
    (tests/test_sharding.py::test_chunked_psum_step_bit_equal).

    The reference has no analog (single device, single command queue); the
    overlap itself is only observable in a device trace on several cards.
    """
    if chunks <= 1:
        return {f: jax.lax.psum(grads[f], axis_name) for f in sorted(grads)}
    out = {}
    for f in sorted(grads):
        g = grads[f]
        n = g.shape[0]
        # ceil-sized slices; the last one may be short (static shapes)
        per = -(-n // chunks)
        bounds = [(i * per, min((i + 1) * per, n)) for i in range(chunks)]
        parts = [
            jax.lax.psum(g[lo:hi], axis_name) for lo, hi in bounds if hi > lo
        ]
        out[f] = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    return out


def make_sharded_train_step(mesh: Mesh, cfg: Config, total_iters: int,
                            grad_psum_chunks: int = 1):
    """Build a jitted sharded step: (state, camera, gt [H,W,3]) ->
    (state, StepMetrics).  Static per (H, W) via the camera's static fields.

    grad_psum_chunks > 1 splits every parameter group's gradient all-reduce
    into that many independent psums along the Gaussian axis (see
    chunked_psum) so the collectives overlap the backward tail on real
    multi-chip hardware; results are bit-identical either way."""
    num_devices = mesh.devices.size

    def step(state: TrainState, camera: Camera, gt_image: jnp.ndarray):
        height, width = camera.height, camera.width
        ts = cfg.raster.tile_size
        rows_per = strip_rows(height, ts, num_devices)
        params = state.params
        capacity = params.capacity

        def device_fn(params, camera, gt_image):
            idx = jax.lax.axis_index(TILE_AXIS)
            row0 = idx * rows_per

            def loss_fn(trainable, vs_dummy):
                p = params.replace(**trainable)
                strip, aux = render(
                    p, camera, cfg.raster, vs_dummy=vs_dummy,
                    tile_rows=(row0, rows_per),
                )
                full = jax.lax.all_gather(strip, TILE_AXIS, axis=0)
                full = full.reshape(num_devices * rows_per * ts, width, 3)
                img = full[:height]
                rep = photometric_loss(img, gt_image, cfg.loss)
                # The loss is computed redundantly on every device, so the
                # all_gather transpose (psum_scatter) sums num_devices
                # identical image cotangents; dividing here makes the later
                # psum of per-device parameter gradients exactly dL/dparams.
                return rep.grad_loss / num_devices, (rep, aux, img)

            trainable = {f: getattr(params, f) for f in optimizer.TRAINABLE}
            vs_zero = jnp.zeros((capacity, 2), jnp.float32)
            (_, (rep, aux, img)), (grads, vs_grad) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True
            )(trainable, vs_zero)

            # complete the per-device partial parameter gradients —
            # chunked per parameter group (SURVEY.md §7.5.6): each slice's
            # all-reduce can start as soon as its cotangent is available
            # instead of waiting for the full backward (the reference has no
            # analog; the overlap itself needs several cards to observe)
            grads = chunked_psum(grads, TILE_AXIS, grad_psum_chunks)
            vs_grad = jax.lax.psum(vs_grad, TILE_AXIS)
            num_pairs = jax.lax.psum(aux.num_pairs, TILE_AXIS)
            overflow = jax.lax.psum(aux.overflow.astype(jnp.int32), TILE_AXIS) > 0
            return grads, vs_grad, rep, img, num_pairs, overflow

        sharded = shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P(), P(), P()),   # params, camera, gt all replicated
            out_specs=(P(), P(), P(), P(), P(), P()),
            check_vma=False,
        )
        grads, vs_grad, rep, img, num_pairs, overflow = sharded(
            params, camera, gt_image
        )

        lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
        new_params, new_opt = optimizer.step(params, grads, state.opt, lrs, cfg.optim)
        new_accum = density.accumulate(
            state.accum, vs_grad, grads["means"], cfg.density
        )
        from gaussiansplatting.train.trainer import (
            _mean_opacity, _mean_world_scale,
        )

        metrics = StepMetrics(
            loss=rep.combined_mean,
            l1=rep.l1_mean,
            dssim=rep.dssim_mean,
            psnr=psnr(img, gt_image),
            num_pairs=num_pairs,
            overflow=overflow,
            position_lr=lrs.position,
            num_gaussians=new_params.count(),
            mean_opacity=_mean_opacity(new_params),
            mean_world_scale=_mean_world_scale(new_params),
        )
        return (
            state.replace(params=new_params, opt=new_opt, accum=new_accum),
            metrics,
        )

    return jax.jit(step)


def make_sharded_train_step_batched(mesh: Mesh, cfg: Config, total_iters: int,
                                    batch_views: int,
                                    grad_psum_chunks: int = 1):
    """Sharded step over K-stacked views: tile strips across devices AND
    mean-loss gradient accumulation over views (train_step_batched composed
    with the strip scheme — the round-2 NotImplementedError).

    Each device vmaps its strip render over the K views; every view's strip
    all_gathers into the full image so the D-SSIM window crosses strip
    boundaries exactly as in the single-view sharded step, and one psum per
    parameter group completes the mean gradient.  Per-view density
    statistics are recovered through per-view zero dummies exactly as in
    train_step_batched (the mean-loss means-gradient would blur the
    per-view contrib gating otherwise)."""
    num_devices = mesh.devices.size
    k = batch_views

    def step(state: TrainState, cameras: Camera, gt_images: jnp.ndarray):
        height, width = cameras.height, cameras.width
        ts = cfg.raster.tile_size
        rows_per = strip_rows(height, ts, num_devices)
        params = state.params
        capacity = params.capacity

        def device_fn(params, cameras, gt_images):
            idx = jax.lax.axis_index(TILE_AXIS)
            row0 = idx * rows_per

            def loss_fn(trainable, vs_dummy, pos_dummy):
                p = params.replace(**trainable)

                def one_view(cam, gt, vs, pos_d):
                    pv = p.replace(means=p.means + pos_d)
                    strip, aux = render(
                        pv, cam, cfg.raster, vs_dummy=vs,
                        tile_rows=(row0, rows_per),
                    )
                    full = jax.lax.all_gather(strip, TILE_AXIS, axis=0)
                    full = full.reshape(num_devices * rows_per * ts, width, 3)
                    img = full[:height]
                    rep = photometric_loss(img, gt, cfg.loss)
                    return rep, aux, img

                rep, aux, imgs = jax.vmap(one_view)(
                    cameras, gt_images, vs_dummy, pos_dummy
                )
                # mean over views; / num_devices for the same all_gather-
                # transpose reason as the single-view sharded step
                return jnp.mean(rep.grad_loss) / num_devices, (rep, aux, imgs)

            trainable = {f: getattr(params, f) for f in optimizer.TRAINABLE}
            vs_zero = jnp.zeros((k, capacity, 2), jnp.float32)
            pos_zero = jnp.zeros((k, capacity, 3), jnp.float32)
            (_, (rep, aux, imgs)), (grads, vs_grad, pos_grad) = (
                jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
                    trainable, vs_zero, pos_zero
                )
            )

            grads = chunked_psum(grads, TILE_AXIS, grad_psum_chunks)
            vs_grad = jax.lax.psum(vs_grad, TILE_AXIS)
            pos_grad = jax.lax.psum(pos_grad, TILE_AXIS)
            # per-view frame totals first (sum strips), THEN the max over
            # views — the quantity per-strip pair capacity must cover
            num_pairs = jnp.max(jax.lax.psum(aux.num_pairs, TILE_AXIS))
            overflow = (
                jax.lax.psum(jnp.any(aux.overflow).astype(jnp.int32), TILE_AXIS)
                > 0
            )
            return grads, vs_grad, pos_grad, rep, imgs, num_pairs, overflow

        sharded = shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(P(),) * 7,
            check_vma=False,
        )
        grads, vs_grad, pos_grad, rep, imgs, num_pairs, overflow = sharded(
            params, cameras, gt_images
        )

        lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
        new_params, new_opt = optimizer.step(params, grads, state.opt, lrs, cfg.optim)

        # per-view density statistics: undo the mean-loss 1/K (see
        # train_step_batched) and fold the K views sequentially
        def fold(accum, view):
            vsg, pg = view
            return density.accumulate(accum, vsg * k, pg * k, cfg.density), None

        new_accum, _ = jax.lax.scan(fold, state.accum, (vs_grad, pos_grad))

        from gaussiansplatting.train.trainer import (
            _mean_opacity, _mean_world_scale,
        )

        metrics = StepMetrics(
            loss=jnp.mean(rep.combined_mean),
            l1=jnp.mean(rep.l1_mean),
            dssim=jnp.mean(rep.dssim_mean),
            psnr=jnp.mean(psnr(imgs, gt_images)),
            num_pairs=num_pairs,
            overflow=overflow,
            position_lr=lrs.position,
            num_gaussians=new_params.count(),
            mean_opacity=_mean_opacity(new_params),
            mean_world_scale=_mean_world_scale(new_params),
        )
        return (
            state.replace(params=new_params, opt=new_opt, accum=new_accum),
            metrics,
        )

    return jax.jit(step)


class ShardedRender(NamedTuple):
    image: jnp.ndarray
    num_pairs: jnp.ndarray


def make_sharded_render(mesh: Mesh, cfg: Config):
    """Inference-only sharded renderer (tile strips + all_gather)."""
    num_devices = mesh.devices.size

    def run(params, camera: Camera) -> ShardedRender:
        height, width = camera.height, camera.width
        ts = cfg.raster.tile_size
        rows_per = strip_rows(height, ts, num_devices)

        def device_fn(params, camera):
            idx = jax.lax.axis_index(TILE_AXIS)
            strip, aux = render(
                params, camera, cfg.raster, tile_rows=(idx * rows_per, rows_per)
            )
            full = jax.lax.all_gather(strip, TILE_AXIS, axis=0)
            full = full.reshape(num_devices * rows_per * ts, width, 3)
            return full[:height], jax.lax.psum(aux.num_pairs, TILE_AXIS)

        sharded = shard_map(
            device_fn, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
            check_vma=False,
        )
        img, pairs = sharded(params, camera)
        return ShardedRender(image=img, num_pairs=pairs)

    return jax.jit(run)
