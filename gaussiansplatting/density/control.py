"""Densify / prune / split density control — jitted masked compaction.

The reference does this entirely on the CPU against shared buffers with a
compacting rebuild into freshly allocated buffers (density_control.mm:188-500).
Here the Gaussian population lives in fixed-capacity padded arrays, so the
rebuild becomes a scatter with cumsum-derived destinations: same interleaved
output order (keep / clone-pair / split-pair), same thresholds, static shapes.

Deliberate divergence from the reference: after the interleaved rebuild the
reference only zeroes Adam state for indices >= oldCount
(mtl_engine.mm:1164-1166), which misaligns every surviving Gaussian's momentum
with its new slot.  We carry m/v through the permutation (official-3DGS
semantics): survivors keep their state, clone copies and split children start
from zero.
"""

from __future__ import annotations

from typing import NamedTuple

from gaussiansplatting.core import pytree
import jax
import jax.numpy as jnp

from gaussiansplatting.config import DensityConfig
from gaussiansplatting.core.gaussians import GaussianParams
from gaussiansplatting.core.transforms import quat_to_rotmat, normalize_quat, sigmoid
from gaussiansplatting.train.optimizer import AdamState, TRAINABLE


@pytree.dataclass
class DensityAccum:
    """Per-Gaussian view-space gradient statistics
    (density_control.mm:121-185)."""

    grad_accum: jnp.ndarray      # [C] sum of clamped ||dL/dscreen|| per view
    grad_count: jnp.ndarray      # [C] int32 contributing views
    pos_grad_accum: jnp.ndarray  # [C, 3] summed position gradients


def init_accum(capacity: int) -> DensityAccum:
    return DensityAccum(
        grad_accum=jnp.zeros((capacity,), jnp.float32),
        grad_count=jnp.zeros((capacity,), jnp.int32),
        pos_grad_accum=jnp.zeros((capacity, 3), jnp.float32),
    )


def accumulate(
    accum: DensityAccum,
    vs_grad: jnp.ndarray,   # [C, 2] this view's screen-space gradient
    pos_grad: jnp.ndarray,  # [C, 3] this view's position gradient
    cfg: DensityConfig,
) -> DensityAccum:
    mag = jnp.linalg.norm(vs_grad, axis=-1)
    mag = jnp.minimum(mag, cfg.viewspace_grad_clip)
    contrib = jnp.isfinite(mag) & (mag > 0.0)
    return DensityAccum(
        grad_accum=accum.grad_accum + jnp.where(contrib, mag, 0.0),
        grad_count=accum.grad_count + contrib.astype(jnp.int32),
        pos_grad_accum=accum.pos_grad_accum
        + jnp.where(contrib[:, None], pos_grad, 0.0),
    )


class DensityStats(NamedTuple):
    pruned: jnp.ndarray
    cloned: jnp.ndarray
    split: jnp.ndarray
    count: jnp.ndarray


def _approx_screen_radius_px(log_scales, focal, avg_depth, max_scale_log):
    """focal * maxScale * 3 / depth in pixels (density_control.mm:56-76)."""
    max_scale = jnp.max(
        jnp.exp(jnp.clip(log_scales, -max_scale_log, max_scale_log)), axis=-1
    )
    return focal * max_scale * 3.0 / jnp.maximum(avg_depth, 0.1)


def apply(
    params: GaussianParams,
    opt: AdamState,
    accum: DensityAccum,
    iteration: jnp.ndarray,
    key: jax.Array,
    scene_extent: float,
    focal: jnp.ndarray,
    avg_depth: jnp.ndarray,
    cfg: DensityConfig,
):
    """One density-control event.  Returns (params, opt, accum, stats).

    Thresholds and ordering match DensityController::apply
    (density_control.mm:188-500) with the engine's call-site arguments
    (mtl_engine.mm:1117-1147: avg_depth = 2*extent, focal at texture scale).
    """
    C = params.capacity
    alive = params.alive
    opacity = sigmoid(params.raw_opacities)
    avg_grad = jnp.where(
        accum.grad_count > 0,
        accum.grad_accum / jnp.maximum(accum.grad_count, 1).astype(jnp.float32),
        0.0,
    )
    max_scale = jnp.max(
        jnp.exp(jnp.clip(params.log_scales, -cfg.max_scale_log, cfg.max_scale_log)),
        axis=-1,
    )

    # ---- decisions (density_control.mm:262-348) ----
    prune = opacity < cfg.opacity_prune_threshold
    screen_pruning = iteration > cfg.opacity_reset_interval
    world_prune = max_scale > cfg.world_prune_factor * scene_extent
    screen_px = _approx_screen_radius_px(
        params.log_scales, focal, avg_depth, cfg.max_scale_log
    )
    prune = prune | (screen_pruning & (world_prune | (screen_px > cfg.screen_prune_pixels)))
    prune = prune & alive

    can_densify = (iteration > cfg.densify_from_iter) & (
        iteration < cfg.densify_until_iter
    )
    wants = alive & ~prune & can_densify & (avg_grad > cfg.grad_threshold)
    split = wants & (max_scale > cfg.percent_dense * scene_extent)
    clone = wants & ~split

    # ---- capacity clamp: drop clones first, then splits, lowest index first
    #      (density_control.mm:358-382); also respect the array capacity ----
    n_alive = jnp.sum(alive.astype(jnp.int32))
    hard_cap = jnp.int32(min(cfg.max_gaussians, C))
    n_pruned = jnp.sum(prune.astype(jnp.int32))
    n_clone = jnp.sum(clone.astype(jnp.int32))
    n_split = jnp.sum(split.astype(jnp.int32))
    new_count = n_alive - n_pruned + n_clone + n_split
    excess = jnp.maximum(new_count - hard_cap, 0)

    clone_rank = jnp.cumsum(clone.astype(jnp.int32)) - 1  # rank among clones
    drop_clones = jnp.minimum(excess, n_clone)
    clone = clone & (clone_rank >= drop_clones)
    excess = excess - drop_clones
    split_rank = jnp.cumsum(split.astype(jnp.int32)) - 1
    drop_splits = jnp.minimum(excess, n_split)
    split = split & (split_rank >= drop_splits)
    n_clone = jnp.sum(clone.astype(jnp.int32))
    n_split = jnp.sum(split.astype(jnp.int32))
    new_count = n_alive - n_pruned + n_clone + n_split

    # ---- split children geometry (density_control.mm:422-480) ----
    scale_lin = jnp.exp(
        jnp.clip(params.log_scales, -cfg.max_scale_log, cfg.max_scale_log)
    )
    r = jax.random.uniform(key, (C, 3), jnp.float32, -1.0, 1.0)
    r_norm = jnp.linalg.norm(r, axis=-1, keepdims=True)
    r = jnp.where(r_norm > 1e-3, r / jnp.maximum(r_norm, 1e-3), r)
    R = quat_to_rotmat(normalize_quat(params.quats))
    offset = jnp.einsum("nij,nj->ni", R, r * scale_lin)
    log_factor = jnp.log(1.0 / cfg.split_scale_factor)

    # ---- interleaved compacting scatter ----
    keep = alive & ~prune & ~clone & ~split
    out_size = (
        keep.astype(jnp.int32) + 2 * clone.astype(jnp.int32) + 2 * split.astype(jnp.int32)
    )
    out_off = jnp.cumsum(out_size) - out_size
    primary_ok = out_size > 0
    primary_dst = jnp.where(primary_ok, out_off, C)
    secondary_ok = out_size == 2
    secondary_dst = jnp.where(secondary_ok, out_off + 1, C)

    def build(field_keep, field_primary, field_secondary):
        buf = jnp.zeros((C + 1,) + field_keep.shape[1:], field_keep.dtype)
        buf = buf.at[primary_dst].set(field_primary, mode="drop")
        buf = buf.at[secondary_dst].set(field_secondary, mode="drop")
        return buf[:C]

    split_col = split[:, None]
    new_means = build(
        params.means,
        jnp.where(split_col, params.means + offset, params.means),
        jnp.where(split_col, params.means - offset, params.means),
    )
    child_scales = params.log_scales + log_factor
    new_scales = build(
        params.log_scales,
        jnp.where(split_col, child_scales, params.log_scales),
        jnp.where(split_col, child_scales, params.log_scales),
    )
    new_quats = build(params.quats, params.quats, params.quats)
    new_ops = build(
        params.raw_opacities, params.raw_opacities, params.raw_opacities
    )
    new_sh = build(params.sh, params.sh, params.sh)

    slot_ids = jnp.arange(C, dtype=jnp.int32)
    new_alive = slot_ids < new_count

    identity_q = jnp.zeros_like(new_quats).at[:, 0].set(1.0)
    new_params = GaussianParams(
        means=new_means,
        log_scales=new_scales,
        quats=jnp.where(new_alive[:, None], new_quats, identity_q),
        raw_opacities=new_ops,
        sh=new_sh,
        alive=new_alive,
    )

    # ---- Adam state through the permutation: survivors + clone-originals
    #      keep state, clone copies and split children start at zero ----
    new_m, new_v = {}, {}
    fresh_primary = split  # split child1 is new
    for f in TRAINABLE:
        m, v = opt.m[f], opt.v[f]
        keep_shape = (slice(None),) + (None,) * (m.ndim - 1)
        prim_m = jnp.where(fresh_primary[keep_shape], 0.0, m)
        prim_v = jnp.where(fresh_primary[keep_shape], 0.0, v)
        new_m[f] = build(m, prim_m, jnp.zeros_like(m))
        new_v[f] = build(v, prim_v, jnp.zeros_like(v))
    new_opt = opt.replace(m=new_m, v=new_v)

    stats = DensityStats(
        pruned=n_pruned, cloned=n_clone, split=n_split, count=new_count
    )
    return new_params, new_opt, init_accum(C), stats
