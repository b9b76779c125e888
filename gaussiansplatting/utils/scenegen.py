"""Photoreal-ish synthetic COLMAP dataset generator.

No Mip-NeRF360 data exists in this environment, so real-scale training
(BASELINE.md config #4) runs on a generated scene instead: a procedurally
textured "garden" (ground plane, stone spheres, box structures) ray-traced
with soft sky + sun lighting into N posed views, an SfM-like noisy surface
point cloud, and COLMAP binary files (cameras.bin / images.bin /
points3D.bin) bit-compatible with the parsers in io/colmap.py (which follow
the reference's colmap_loader.cpp:26-230).

The renderer is plain jitted JAX — multi-bounce-free Lambertian with hard
shadows and 4-octave value-noise textures — enough texture frequency to make
densification work for its living.
"""

from __future__ import annotations

import functools
import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# scene description (world units ~metres, y up)
# ---------------------------------------------------------------------------

SPHERES = np.array(
    [
        # cx, cy, cz, radius, palette
        [1.8, 0.45, 0.6, 0.45, 2],
        [-1.2, 0.35, 1.4, 0.35, 3],
        [0.4, 0.25, -1.6, 0.25, 2],
        [-2.1, 0.55, -0.8, 0.55, 4],
        [2.6, 0.3, -1.9, 0.3, 3],
        [-0.3, 0.2, 2.3, 0.2, 4],
        [1.0, 1.05, 1.9, 0.28, 5],   # "fruit" on the hedge
        [-1.7, 0.9, -2.4, 0.9, 5],   # bush
    ],
    np.float32,
)

BOXES = np.array(
    [
        # min xyz, max xyz, palette
        [-0.9, 0.0, -0.5, 0.9, 1.1, 0.5, 1],    # house core
        [-1.1, 1.1, -0.7, 1.1, 1.45, 0.7, 6],   # roof slab
        [0.7, 0.0, 1.6, 1.3, 0.8, 2.2, 1],      # hedge block
        [-2.9, 0.0, 1.8, -2.3, 1.3, 2.4, 6],    # pillar
        [2.2, 0.0, 0.9, 3.0, 0.5, 1.7, 4],      # low wall
    ],
    np.float32,
)

SUN_DIR = np.array([0.45, 0.8, 0.35], np.float32)
SUN_DIR /= np.linalg.norm(SUN_DIR)
GROUND_EXTENT = 14.0

_PALETTES = np.array(
    [
        # base rgb, noise rgb amplitude, noise scale
        [0.23, 0.42, 0.16, 0.10, 0.14, 0.06, 2.6],   # 0 grass
        [0.58, 0.34, 0.24, 0.16, 0.10, 0.08, 6.0],   # 1 brick
        [0.46, 0.46, 0.48, 0.14, 0.14, 0.14, 4.0],   # 2 stone
        [0.62, 0.52, 0.30, 0.12, 0.12, 0.10, 8.0],   # 3 sand
        [0.30, 0.34, 0.52, 0.10, 0.10, 0.16, 3.2],   # 4 slate blue
        [0.55, 0.16, 0.14, 0.14, 0.08, 0.06, 9.0],   # 5 berry red
        [0.42, 0.30, 0.20, 0.12, 0.10, 0.08, 5.0],   # 6 wood
    ],
    np.float32,
)


def _scene_arrays(jnp):
    return (
        jnp.asarray(SPHERES), jnp.asarray(BOXES), jnp.asarray(_PALETTES),
        jnp.asarray(SUN_DIR),
    )


def _hash3(jnp, ix, iy, iz):
    h = (
        ix.astype(jnp.float32) * 127.1
        + iy.astype(jnp.float32) * 311.7
        + iz.astype(jnp.float32) * 74.7
    )
    return jnp.mod(jnp.sin(h) * 43758.5453, 1.0)


def _value_noise(jnp, p):
    """Trilinear value noise in [0,1] over the integer lattice."""
    pi = jnp.floor(p)
    pf = p - pi
    w = pf * pf * (3.0 - 2.0 * pf)
    ix, iy, iz = pi[..., 0], pi[..., 1], pi[..., 2]

    def h(dx, dy, dz):
        return _hash3(jnp, ix + dx, iy + dy, iz + dz)

    x00 = h(0, 0, 0) * (1 - w[..., 0]) + h(1, 0, 0) * w[..., 0]
    x10 = h(0, 1, 0) * (1 - w[..., 0]) + h(1, 1, 0) * w[..., 0]
    x01 = h(0, 0, 1) * (1 - w[..., 0]) + h(1, 0, 1) * w[..., 0]
    x11 = h(0, 1, 1) * (1 - w[..., 0]) + h(1, 1, 1) * w[..., 0]
    y0 = x00 * (1 - w[..., 1]) + x10 * w[..., 1]
    y1 = x01 * (1 - w[..., 1]) + x11 * w[..., 1]
    return y0 * (1 - w[..., 2]) + y1 * w[..., 2]


def _fbm(jnp, p):
    v = 0.0
    amp = 0.5
    for _ in range(4):
        v = v + amp * _value_noise(jnp, p)
        p = p * 2.03 + 11.31
        amp *= 0.5
    return v


def _texture(jnp, palettes, pal_id, p):
    """Albedo at world point p for palette pal_id ([..., 3])."""
    row = palettes[pal_id]
    base = row[..., 0:3]
    amp = row[..., 3:6]
    scale = row[..., 6:7]
    n = _fbm(jnp, p * scale)[..., None]
    n2 = _fbm(jnp, p * scale * 3.7 + 5.0)[..., None]
    alb = base + amp * (n - 0.5) * 2.0 + amp * (n2 - 0.5) * 0.7
    return jnp.clip(alb, 0.02, 0.98)


def _intersect(jnp, spheres, boxes, origins, dirs, t_max=1e9):
    """Nearest hit over plane / spheres / boxes.

    Returns (t, hit_mask, normal, pal_id).  origins/dirs [..., 3].
    """
    big = jnp.float32(t_max)
    best_t = jnp.full(origins.shape[:-1], big)
    best_n = jnp.zeros_like(origins).at[..., 1].set(1.0)
    best_pal = jnp.zeros(origins.shape[:-1], jnp.int32)

    # ground plane y=0 (finite square)
    dy = dirs[..., 1]
    t_pl = jnp.where(jnp.abs(dy) > 1e-6, -origins[..., 1] / dy, big)
    p_pl = origins + t_pl[..., None] * dirs
    ok_pl = (
        (t_pl > 1e-3)
        & (jnp.abs(p_pl[..., 0]) < GROUND_EXTENT)
        & (jnp.abs(p_pl[..., 2]) < GROUND_EXTENT)
    )
    upd = ok_pl & (t_pl < best_t)
    best_t = jnp.where(upd, t_pl, best_t)
    best_pal = jnp.where(upd, 0, best_pal)
    n_pl = jnp.zeros_like(origins).at[..., 1].set(1.0)
    best_n = jnp.where(upd[..., None], n_pl, best_n)

    # spheres
    for i in range(spheres.shape[0]):
        c = spheres[i, 0:3]
        r = spheres[i, 3]
        pal = spheres[i, 4].astype(jnp.int32)
        oc = origins - c
        b = jnp.sum(oc * dirs, axis=-1)
        cc = jnp.sum(oc * oc, axis=-1) - r * r
        disc = b * b - cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = -b - sq
        t1 = -b + sq
        t_s = jnp.where(t0 > 1e-3, t0, t1)
        ok = (disc > 0.0) & (t_s > 1e-3)
        upd = ok & (t_s < best_t)
        p = origins + t_s[..., None] * dirs
        n = (p - c) / r
        best_t = jnp.where(upd, t_s, best_t)
        best_pal = jnp.where(upd, pal, best_pal)
        best_n = jnp.where(upd[..., None], n, best_n)

    # axis-aligned boxes (slab test)
    for i in range(boxes.shape[0]):
        bmin = boxes[i, 0:3]
        bmax = boxes[i, 3:6]
        pal = boxes[i, 6].astype(jnp.int32)
        inv = 1.0 / jnp.where(jnp.abs(dirs) > 1e-9, dirs, 1e-9)
        t_lo = (bmin - origins) * inv
        t_hi = (bmax - origins) * inv
        t1 = jnp.minimum(t_lo, t_hi)
        t2 = jnp.maximum(t_lo, t_hi)
        t_near = jnp.max(t1, axis=-1)
        t_far = jnp.min(t2, axis=-1)
        ok = (t_near < t_far) & (t_far > 1e-3)
        t_b = jnp.where(t_near > 1e-3, t_near, t_far)
        upd = ok & (t_b < best_t)
        # normal: axis of the entering slab
        axis = jnp.argmax(t1, axis=-1)
        sign = -jnp.sign(dirs)
        n = jnp.stack(
            [sign[..., k] * (axis == k) for k in range(3)], axis=-1
        ).astype(jnp.float32)
        best_t = jnp.where(upd, t_b, best_t)
        best_pal = jnp.where(upd, pal, best_pal)
        best_n = jnp.where(upd[..., None], n, best_n)

    hit = best_t < big * 0.5
    return best_t, hit, best_n, best_pal


def _sky(jnp, dirs, sun_dir):
    up = jnp.clip(dirs[..., 1], -1.0, 1.0)
    horizon = jnp.array([0.82, 0.86, 0.92], jnp.float32)
    zenith = jnp.array([0.35, 0.52, 0.82], jnp.float32)
    t = jnp.clip(up * 0.5 + 0.5, 0.0, 1.0)[..., None]
    sky = horizon * (1 - t) + zenith * t
    sun = jnp.clip(jnp.sum(dirs * sun_dir, axis=-1), 0.0, 1.0) ** 256
    return jnp.clip(sky + sun[..., None] * jnp.asarray([1.2, 1.1, 0.9]), 0.0, 1.0)


def shade(jnp, points, normals, pal_id, spheres, boxes, palettes, sun_dir):
    alb = _texture(jnp, palettes, pal_id, points)
    ndl = jnp.clip(jnp.sum(normals * sun_dir, axis=-1), 0.0, 1.0)
    # hard shadow ray
    s_org = points + normals * 1e-3
    s_dir = jnp.broadcast_to(sun_dir, points.shape)
    _, s_hit, _, _ = _intersect(jnp, spheres, boxes, s_org, s_dir)
    lit = ndl * (1.0 - s_hit.astype(jnp.float32))
    ambient = 0.35 + 0.1 * jnp.clip(normals[..., 1], 0.0, 1.0)
    return jnp.clip(alb * (ambient + 0.85 * lit)[..., None], 0.0, 1.0)


@functools.lru_cache(maxsize=1)
def _render_view_jit():
    """Module-level jitted renderer: the pose is an ARGUMENT (not a
    closed-over constant), and the wrapper itself is cached, so every view
    of a dataset shares ONE compiled program per resolution."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
    def go(Rt, eye, fx, fy, cx, cy, width, height):
        spheres, boxes, palettes, sun_dir = _scene_arrays(jnp)
        xs = (jnp.arange(width, dtype=jnp.float32) + 0.5 - cx) / fx
        ys = (jnp.arange(height, dtype=jnp.float32) + 0.5 - cy) / fy
        gx, gy = jnp.meshgrid(xs, ys)
        d_cam = jnp.stack([gx, gy, jnp.ones_like(gx)], axis=-1)
        d_world = d_cam @ Rt.T
        d_world = d_world / jnp.linalg.norm(d_world, axis=-1, keepdims=True)
        origins = jnp.broadcast_to(eye, d_world.shape)

        t_hit, hit, n, pal = _intersect(jnp, spheres, boxes, origins, d_world)
        p = origins + t_hit[..., None] * d_world
        col = shade(jnp, p, n, pal, spheres, boxes, palettes, sun_dir)
        sky = _sky(jnp, d_world, sun_dir)
        return jnp.where(hit[..., None], col, sky)

    return go


def render_view(R: np.ndarray, t: np.ndarray, fx: float, fy: float,
                cx: float, cy: float, width: int, height: int) -> np.ndarray:
    """Ray-trace one COLMAP-posed view (x_cam = R x + t); returns [H, W, 3]
    float32 in [0, 1]."""
    import jax.numpy as jnp

    eye = jnp.asarray(-R.T @ t, np.float32)
    Rt = jnp.asarray(R.T, np.float32)
    go = _render_view_jit()
    return np.asarray(
        go(Rt, eye, float(fx), float(fy), float(cx), float(cy), width, height),
        np.float32,
    )


def sample_surface_points(n: int, seed: int = 0, noise: float = 0.01):
    """SfM-like sparse cloud: surface samples with shaded colors + position
    noise, weighted toward textured geometry like real feature matching."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    spheres, boxes, palettes, sun_dir = _scene_arrays(jnp)

    pts, nrm, pal = [], [], []

    n_ground = n // 3
    g = rng.uniform(-0.55 * GROUND_EXTENT, 0.55 * GROUND_EXTENT, (n_ground, 2))
    pts.append(np.stack([g[:, 0], np.zeros(n_ground), g[:, 1]], axis=1))
    nrm.append(np.tile([0.0, 1.0, 0.0], (n_ground, 1)))
    pal.append(np.zeros(n_ground, np.int64))

    n_rest = n - n_ground
    area_s = 4 * np.pi * SPHERES[:, 3] ** 2
    ext = BOXES[:, 3:6] - BOXES[:, 0:3]
    area_b = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2])
    areas = np.concatenate([area_s, area_b])
    counts = rng.multinomial(n_rest, areas / areas.sum())
    for i, cnt in enumerate(counts[: len(SPHERES)]):
        v = rng.standard_normal((cnt, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        pts.append(SPHERES[i, 0:3] + v * SPHERES[i, 3])
        nrm.append(v)
        pal.append(np.full(cnt, int(SPHERES[i, 4]), np.int64))
    for i, cnt in enumerate(counts[len(SPHERES):]):
        bmin, bmax = BOXES[i, 0:3], BOXES[i, 3:6]
        face = rng.integers(0, 6, cnt)
        u = rng.uniform(0, 1, (cnt, 3))
        p = bmin + u * (bmax - bmin)
        nv = np.zeros((cnt, 3), np.float32)
        for axis in range(3):
            lo = face == 2 * axis
            hi = face == 2 * axis + 1
            p[lo, axis] = bmin[axis]
            p[hi, axis] = bmax[axis]
            nv[lo, axis] = -1.0
            nv[hi, axis] = 1.0
        pts.append(p)
        nrm.append(nv)
        pal.append(np.full(cnt, int(BOXES[i, 6]), np.int64))

    pts = np.concatenate(pts).astype(np.float32)
    nrm = np.concatenate(nrm).astype(np.float32)
    pal = np.concatenate(pal)

    cols = np.asarray(
        shade(jnp, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(pal),
              spheres, boxes, palettes, sun_dir)
    )
    pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    cols = np.clip(
        cols + rng.normal(0, 0.02, cols.shape).astype(np.float32), 0, 1
    )
    return pts, cols


# ---------------------------------------------------------------------------
# COLMAP binary writers (inverse of io/colmap.py parsers)
# ---------------------------------------------------------------------------

def write_cameras_bin(path: str, fx, fy, cx, cy, width, height) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<Ii", 1, 1))  # camera 1, model 1 = PINHOLE fx fy cx cy
        f.write(struct.pack("<QQ", width, height))
        f.write(struct.pack("<4d", fx, fy, cx, cy))


def write_images_bin(path: str, poses: list[tuple[np.ndarray, np.ndarray, str]]) -> None:
    """poses: [(quat_wxyz, translation, image_name)] with x_cam = R x + t."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (q, t, name) in enumerate(poses):
            f.write(struct.pack("<I", i + 1))
            f.write(struct.pack("<7d", *[float(v) for v in q], *[float(v) for v in t]))
            f.write(struct.pack("<I", 1))
            f.write(name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points


def write_points_bin(path: str, positions: np.ndarray, colors: np.ndarray) -> None:
    rgb = np.clip(np.asarray(colors) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(positions)))
        for i, (p, c) in enumerate(zip(np.asarray(positions, np.float64), rgb)):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", *c))
            f.write(struct.pack("<d", 0.5))   # reprojection error
            f.write(struct.pack("<Q", 0))     # empty track


def camera_ring_poses(num_views: int, seed: int = 0):
    """Camera poses on two jittered rings looking at the scene center,
    world up (0, 1, 0).  Returns [(quat_wxyz, t, name)]."""
    from gaussiansplatting.core.camera import look_at_view, rotmat_to_quat_wxyz

    rng = np.random.default_rng(seed)
    poses = []
    target = np.array([0.0, 0.6, 0.0], np.float32)
    for i in range(num_views):
        az = 2 * np.pi * i / num_views + rng.uniform(-0.02, 0.02)
        ring = i % 2
        radius = (5.2, 6.8)[ring] + rng.uniform(-0.3, 0.3)
        h = (1.4, 2.6)[ring] + rng.uniform(-0.2, 0.2)
        eye = np.array(
            [radius * np.cos(az), h, radius * np.sin(az)], np.float32
        )
        tgt = target + rng.uniform(-0.08, 0.08, 3).astype(np.float32)
        R, t = look_at_view(eye, tgt, up=(0.0, 1.0, 0.0))
        q = rotmat_to_quat_wxyz(R)
        poses.append((q, t, f"view_{i:04d}.png"))
    return poses


def generate_dataset(
    out_dir: str,
    num_views: int = 200,
    width: int = 800,
    height: int = 608,
    num_points: int = 150_000,
    seed: int = 0,
    fov_deg: float = 60.0,
    log=print,
) -> None:
    """Write <out_dir>/images/*.png and <out_dir>/sparse/0/*.bin."""
    from gaussiansplatting.io.images import save_png

    img_dir = os.path.join(out_dir, "images")
    sparse_dir = os.path.join(out_dir, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sparse_dir, exist_ok=True)

    fx = fy = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
    cx, cy = width / 2.0, height / 2.0

    poses = camera_ring_poses(num_views, seed=seed)
    from gaussiansplatting.core.transforms import quat_to_rotmat
    import jax.numpy as jnp

    for i, (q, t, name) in enumerate(poses):
        R = np.asarray(quat_to_rotmat(jnp.asarray(q, jnp.float32)))
        img = render_view(R, t, fx, fy, cx, cy, width, height)
        save_png(os.path.join(img_dir, name), img)
        if (i + 1) % 25 == 0:
            log(f"rendered {i + 1}/{num_views} views")

    pts, cols = sample_surface_points(num_points, seed=seed + 1)
    write_cameras_bin(os.path.join(sparse_dir, "cameras.bin"), fx, fy, cx, cy, width, height)
    write_images_bin(os.path.join(sparse_dir, "images.bin"), poses)
    write_points_bin(os.path.join(sparse_dir, "points3D.bin"), pts, cols)
    log(f"dataset at {out_dir}: {num_views} views {width}x{height}, "
        f"{len(pts)} SfM points")
