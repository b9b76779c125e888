"""Scalar NumPy oracle implementing the reference's exact rasterization
semantics (tiled_shaders.metal:102-385) for parity tests.

This is deliberately slow and literal: per-Gaussian projection with every cull
branch, per-pixel front-to-back blending with the power window, alpha floor,
alpha cap, and T-termination — the behavioral spec our renderer is tested
against.  Runs in float64 to act as ground truth.
"""

from __future__ import annotations

import numpy as np

SH_C0 = 0.28209479177387814


def quat_to_rotmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def project_one(
    mean,
    log_scale,
    quat,
    raw_opacity,
    sh_dc,
    view,
    viewproj,
    fx,
    fy,
    width,
    height,
    tile_size=16,
    max_radius=512.0,
    max_log_scale=5.0,
):
    """Returns dict or None if culled, mirroring projectGaussians."""
    if not np.all(np.isfinite(mean)) or not np.all(np.isfinite(log_scale)):
        return None
    if np.any(np.abs(mean) > 1e6):
        return None

    homo = np.append(mean, 1.0)
    view_pos = view @ homo
    clip = viewproj @ homo
    if clip[3] <= 0.1 or view_pos[2] <= 0.1:
        return None
    ndc = clip[:3] / clip[3]
    if abs(ndc[0]) > 1.2 or abs(ndc[1]) > 1.2:
        return None
    screen = np.array([(ndc[0] * 0.5 + 0.5) * width, (ndc[1] * 0.5 + 0.5) * height])

    scale = np.exp(np.clip(log_scale, -max_log_scale, max_log_scale))
    max_s, min_s = scale.max(), scale.min()
    if max_s > 20.0 * min_s:
        scale = scale * (20.0 * min_s / max_s)

    q = np.asarray(quat, np.float64)
    qlen = np.linalg.norm(q)
    q = q / qlen if qlen > 1e-3 else np.array([1.0, 0, 0, 0])
    R = quat_to_rotmat(q)
    M = R @ np.diag(scale)
    sigma3d = M @ M.T

    z = view_pos[2]
    limx, limy = 1.3 * fx / z, 1.3 * fy / z
    txtz = np.clip(view_pos[0] / z, -limx, limx)
    tytz = np.clip(view_pos[1] / z, -limy, limy)
    J = np.array(
        [[fx / z, 0, -fx * txtz / z], [0, fy / z, -fy * tytz / z], [0, 0, 0]]
    )
    W = view[:3, :3]
    T = J @ W
    cov2d = T @ sigma3d @ T.T
    a = cov2d[0, 0] + 0.3
    b = cov2d[0, 1]
    c = cov2d[1, 1] + 0.3

    det = a * c - b * b
    if det < 1e-4:
        return None
    conic = np.array([c / det, -b / det, a / det])

    mid = 0.5 * (a + c)
    lam1 = mid + np.sqrt(max(0.1, mid * mid - det))
    radius = min(np.ceil(3.0 * np.sqrt(lam1)), max_radius)
    if radius <= 0:
        return None

    min_x = max(0, int(screen[0] - radius))
    min_y = max(0, int(screen[1] - radius))
    max_x = min(width - 1, int(screen[0] + radius))
    max_y = min(height - 1, int(screen[1] + radius))
    if min_x > max_x or min_y > max_y:
        return None

    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    tmin = (min_x // tile_size, min_y // tile_size)
    tmax = (
        min(max_x // tile_size, tiles_x - 1),
        min(max_y // tile_size, tiles_y - 1),
    )
    span = (tmax[0] - tmin[0] + 1) * (tmax[1] - tmin[1] + 1)
    if span > 256:
        return None

    opacity = 1.0 / (1.0 + np.exp(-np.clip(raw_opacity, -8.0, 8.0)))
    color = np.clip(SH_C0 * np.asarray(sh_dc) + 0.5, 0.0, 1.0)

    return dict(
        screen=screen,
        conic=conic,
        depth=view_pos[2],
        opacity=opacity,
        color=color,
        radius=radius,
        tmin=tmin,
        tmax=tmax,
    )


def render_reference(
    means,
    log_scales,
    quats,
    raw_opacities,
    sh_dc,
    view,
    viewproj,
    fx,
    fy,
    width,
    height,
    tile_size=16,
    white_background=True,
    t_floor=1e-4,
):
    """Full-image oracle render.  Returns [H, W, 3] float64."""
    n = len(means)
    projected = []
    for i in range(n):
        p = project_one(
            means[i], log_scales[i], quats[i], raw_opacities[i], sh_dc[i],
            view, viewproj, fx, fy, width, height, tile_size,
        )
        if p is not None and p["opacity"] >= 0.005:  # pairgen floor
            projected.append((i, p))

    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    tile_lists = {}
    for i, p in projected:
        for ty in range(p["tmin"][1], p["tmax"][1] + 1):
            for tx in range(p["tmin"][0], p["tmax"][0] + 1):
                tile_lists.setdefault(ty * tiles_x + tx, []).append((p["depth"], i, p))
    for lst in tile_lists.values():
        lst.sort(key=lambda e: e[0])

    bg = 1.0 if white_background else 0.0
    img = np.full((height, width, 3), bg, np.float64)
    for tid, lst in tile_lists.items():
        ty, tx = divmod(tid, tiles_x)
        for py in range(ty * tile_size, min((ty + 1) * tile_size, height)):
            for px in range(tx * tile_size, min((tx + 1) * tile_size, width)):
                color = np.zeros(3)
                T = 1.0
                pix = np.array([px + 0.5, py + 0.5])
                for _depth, _i, p in lst:
                    if T <= t_floor:
                        break
                    d = pix - p["screen"]
                    cn = p["conic"]
                    if abs(cn[0]) + abs(cn[1]) + abs(cn[2]) < 1e-4:
                        continue
                    power = -0.5 * (
                        cn[0] * d[0] * d[0]
                        + 2.0 * cn[1] * d[0] * d[1]
                        + cn[2] * d[1] * d[1]
                    )
                    if power > 0.0 or power < -4.5:
                        continue
                    alpha = min(p["opacity"] * np.exp(power), 0.99)
                    if alpha < 1.0 / 255.0:
                        continue
                    color += p["color"] * alpha * T
                    T *= 1.0 - alpha
                img[py, px] = color + bg * T
    return img
