"""Screen-space projection of all Gaussians for one camera.

Vectorized equivalent of the reference's per-thread ``projectGaussians``
kernel (tiled_shaders.metal:102-304): every cull branch becomes a mask, and
the output is a fixed-shape struct-of-arrays (the reference's
ProjectedGaussian AoS, tiled_rasterizer.hpp:24-39, turned into SoA so the VPU
streams each field).
"""

from __future__ import annotations

from gaussiansplatting.core import pytree
import jax.numpy as jnp

from gaussiansplatting.config import RasterConfig
from gaussiansplatting.core.camera import Camera
from gaussiansplatting.core.gaussians import GaussianParams
from gaussiansplatting.core import transforms as T


@pytree.dataclass
class Projected:
    """Per-Gaussian screen-space quantities (SoA).  Culled Gaussians have
    valid=False and radius=0, matching the reference's radius<=0 convention."""

    screen_pos: jnp.ndarray   # [N, 2] pixel coords
    conic: jnp.ndarray        # [N, 3] (A, B, C) of the inverse 2D covariance
    depth: jnp.ndarray        # [N] view-space z (positive in front)
    opacity: jnp.ndarray      # [N] sigmoid opacity
    color: jnp.ndarray        # [N, 3] clamped DC color
    radius: jnp.ndarray       # [N] 3-sigma pixel radius (0 = culled)
    tile_min: jnp.ndarray     # [N, 2] (tx, ty) inclusive
    tile_max: jnp.ndarray     # [N, 2] (tx, ty) inclusive
    n_tiles: jnp.ndarray      # [N] tiles covered (0 = culled / skipped)
    valid: jnp.ndarray        # [N] bool


def num_tiles(size: int, tile: int) -> int:
    return -(-size // tile)


def project(
    params: GaussianParams,
    camera: Camera,
    cfg: RasterConfig,
) -> Projected:
    """Project all Gaussians; everything masked, no data-dependent shapes."""
    width, height = camera.width, camera.height
    tiles_x = num_tiles(width, cfg.tile_size)
    tiles_y = num_tiles(height, cfg.tile_size)

    means = params.means
    # NaN / magnitude guard (tiled_shaders.metal:120-125)
    finite = jnp.all(jnp.isfinite(means), axis=-1) & jnp.all(
        jnp.isfinite(params.log_scales), axis=-1
    )
    in_range = jnp.all(jnp.abs(means) <= 1e6, axis=-1)
    ok = params.alive & finite & in_range

    homo = jnp.concatenate([means, jnp.ones_like(means[:, :1])], axis=-1)  # [N,4]
    view_pos = homo @ camera.view.T     # [N,4]
    clip_pos = homo @ camera.viewproj.T
    w = clip_pos[:, 3]
    vz = view_pos[:, 2]
    # Depth cull (tiled_shaders.metal:135)
    ok &= (w > cfg.z_cull) & (vz > cfg.z_cull)

    safe_w = jnp.where(ok, w, 1.0)
    ndc = clip_pos[:, :3] / safe_w[:, None]
    # Frustum cull (tiled_shaders.metal:144)
    ok &= (jnp.abs(ndc[:, 0]) <= cfg.ndc_cull) & (jnp.abs(ndc[:, 1]) <= cfg.ndc_cull)

    screen_pos = jnp.stack(
        [
            (ndc[:, 0] * 0.5 + 0.5) * width,
            (ndc[:, 1] * 0.5 + 0.5) * height,
        ],
        axis=-1,
    )

    # 3D covariance (tiled_shaders.metal:159-190)
    log_scale = jnp.clip(params.log_scales, -cfg.max_log_scale, cfg.max_log_scale)
    scale = T.clamp_scale_aspect(jnp.exp(log_scale), cfg.aspect_clamp)
    q = T.normalize_quat(params.quats)
    cov3d = T.covariance_3d(scale, q)

    # EWA projection; guard z with 'ok' to keep the division finite.
    safe_view = view_pos[:, :3].at[:, 2].set(jnp.where(ok, vz, 1.0))
    cov2d = T.ewa_project(
        cov3d,
        safe_view,
        camera.view[:3, :3],
        camera.fx,
        camera.fy,
        cfg.jacobian_clamp,
        cfg.lowpass,
    )
    conic, _det, det_ok = T.conic_from_cov2d(cov2d, cfg.min_det)
    ok &= det_ok

    radius = T.radius_from_cov2d(cov2d, cfg.max_radius)
    ok &= radius > 0

    # Pixel-rect -> tile-rect (tiled_shaders.metal:263-281)
    min_x = jnp.maximum(0, (screen_pos[:, 0] - radius).astype(jnp.int32))
    min_y = jnp.maximum(0, (screen_pos[:, 1] - radius).astype(jnp.int32))
    max_x = jnp.minimum(width - 1, (screen_pos[:, 0] + radius).astype(jnp.int32))
    max_y = jnp.minimum(height - 1, (screen_pos[:, 1] + radius).astype(jnp.int32))
    ok &= (min_x <= max_x) & (min_y <= max_y)

    tmin_x = min_x // cfg.tile_size
    tmin_y = min_y // cfg.tile_size
    tmax_x = jnp.minimum(max_x // cfg.tile_size, tiles_x - 1)
    tmax_y = jnp.minimum(max_y // cfg.tile_size, tiles_y - 1)

    span = (tmax_x - tmin_x + 1) * (tmax_y - tmin_y + 1)
    # Tile-coverage cap (tiled_shaders.metal:286)
    ok &= span <= cfg.max_tiles_per_gaussian

    opacity = T.sigmoid(
        jnp.clip(params.raw_opacities, -cfg.raw_opacity_clamp, cfg.raw_opacity_clamp)
    )
    # Pair-gen opacity floor (tiled_shaders.metal:742,762): Gaussians below it
    # produce no pairs at all.
    emit = ok & (opacity >= cfg.pair_min_opacity)

    if cfg.sh_degree >= 1:
        rel = means - camera.cam_pos[None, :]
        norm = jnp.linalg.norm(rel, axis=-1, keepdims=True)
        dirs = rel / jnp.maximum(norm, 1e-8)
        color = T.sh_eval(params.sh, dirs, cfg.sh_degree)
    else:
        color = T.sh_dc_to_rgb(params.sh[:, 0, :])

    zero_i = jnp.zeros_like(tmin_x)
    return Projected(
        screen_pos=jnp.where(ok[:, None], screen_pos, 0.0),
        conic=jnp.where(ok[:, None], conic, 0.0),
        depth=jnp.where(ok, vz, 0.0),
        opacity=jnp.where(ok, opacity, 0.0),
        color=jnp.where(ok[:, None], color, 0.0),
        radius=jnp.where(ok, radius, 0.0),
        tile_min=jnp.stack(
            [jnp.where(ok, tmin_x, zero_i), jnp.where(ok, tmin_y, zero_i)], axis=-1
        ),
        tile_max=jnp.stack(
            [jnp.where(ok, tmax_x, zero_i), jnp.where(ok, tmax_y, zero_i)], axis=-1
        ),
        n_tiles=jnp.where(emit, span, 0),
        valid=ok,
    )
