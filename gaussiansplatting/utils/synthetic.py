"""Synthetic scene generation for benchmarks, smoke tests, and the driver
entry points.

The reference has no synthetic-data path — its only inputs are COLMAP scenes
(main.mm:299-492) — but a deterministic random scene in front of a canonical
camera exercises every kernel (projection, pair expansion, sort, blend,
backward) without touching the filesystem.
"""

from __future__ import annotations

import numpy as np

from gaussiansplatting.core import gaussians as gaussians_mod
from gaussiansplatting.core.camera import Camera, make_camera
from gaussiansplatting.core.gaussians import GaussianParams


def make_scene(
    n: int,
    seed: int = 0,
    spread: float = 1.0,
    z_center: float = 4.0,
    capacity: int | None = None,
    log_scale_range: tuple = (-4.6, -3.0),
) -> GaussianParams:
    """Random Gaussians in a box in front of the canonical camera (identity
    pose looking down +z, the COLMAP convention).

    The default log-scale range gives ~2-8 covered tiles per Gaussian at the
    canonical camera — the same pairs-per-Gaussian regime as a converged real
    scene — so benchmarks measure a representative workload.
    """
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [
            rng.uniform(-spread, spread, (n, 2)),
            rng.uniform(z_center - 1.0, z_center + 1.0, (n, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    log_scales = rng.uniform(*log_scale_range, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    raw_op = rng.uniform(-1.0, 3.0, (n,)).astype(np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return gaussians_mod.from_arrays(
        means, log_scales, quats, raw_op, sh, capacity=capacity
    )


def make_canonical_camera(
    width: int = 128, height: int = 128, fov_scale: float = 1.2
) -> Camera:
    """Identity-pose camera whose intrinsics frame the make_scene unit box."""
    return make_camera(
        quat_wxyz=np.array([1.0, 0.0, 0.0, 0.0], np.float32),
        translation=np.zeros(3, np.float32),
        fx=width * fov_scale,
        fy=width * fov_scale,
        cx=width / 2.0,
        cy=height / 2.0,
        cam_width=width,
        cam_height=height,
    )
