"""Gaussian initialization from a COLMAP point cloud.

Reference: gaussiansFromColmap (main.mm:59-187) — isotropic log scales from
mean 3-NN distances (point clouds >10k: 1000-point sample, median assigned to
all, main.mm:87-123), clamped to [1e-4, 0.1] * scene extent, identity
quaternions, raw opacity 0 (sigmoid = 0.5), SH DC = (rgb - 0.5)/SH_C0.

The O(N^2) brute-force kNN of the reference becomes a KD-tree
(scipy.spatial.cKDTree) — same result, O(N log N); ``knn_mode='exact'``
additionally upgrades the >10k path to true per-point kNN instead of the
reference's one-median-for-everyone shortcut.
"""

from __future__ import annotations

import numpy as np

from gaussiansplatting.config import InitConfig
from gaussiansplatting.core.transforms import SH_C0
from gaussiansplatting.io.ply import GaussianCloud


def knn_mean_distances(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbours per point."""
    from gaussiansplatting.io import native

    out = native.knn_mean_dist(points, k)
    if out is not None:
        return out
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    # query k+1: the nearest hit is the point itself
    dist, _ = tree.query(points, k=k + 1, workers=-1)
    return dist[:, 1:].mean(axis=1).astype(np.float32)


def initial_scales(
    points: np.ndarray, cfg: InitConfig, knn_mode: str = "reference"
) -> np.ndarray:
    n = points.shape[0]
    if knn_mode == "reference" and n > cfg.knn_sample_threshold:
        # sample at regular intervals, take the median, assign to all
        # (main.mm:92-116)
        step = max(n // cfg.knn_sample_size, 1)
        sample_idx = np.arange(0, n, step)
        sample = knn_mean_distances(points[sample_idx], cfg.knn_k)
        # NOTE: the reference computes each sampled point's kNN against the
        # FULL cloud; a KD-tree over the sample alone would overestimate, so
        # query sampled points against the full tree.
        from scipy.spatial import cKDTree

        tree = cKDTree(points)
        dist, _ = tree.query(points[sample_idx], k=cfg.knn_k + 1, workers=-1)
        sample = dist[:, 1:].mean(axis=1)
        median = float(np.sort(sample)[sample.size // 2])
        return np.full((n,), median, np.float32)
    return knn_mean_distances(points, cfg.knn_k)


def gaussians_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    scene_extent: float,
    cfg: InitConfig = InitConfig(),
    knn_mode: str = "reference",
) -> GaussianCloud:
    n = points.shape[0]
    scales = initial_scales(points, cfg, knn_mode)
    scales = np.clip(
        scales,
        cfg.min_scale_factor * scene_extent,
        cfg.max_scale_factor * scene_extent,
    )
    log_scales = np.repeat(np.log(scales)[:, None], 3, axis=1).astype(np.float32)

    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = (np.asarray(colors, np.float32) - 0.5) / SH_C0

    return GaussianCloud(
        means=np.asarray(points, np.float32),
        log_scales=log_scales,
        quats=quats,
        raw_opacities=np.full((n,), cfg.init_raw_opacity, np.float32),
        sh=sh,
    )
