"""Scene dataset assembly: COLMAP reconstruction + images -> training-ready
(cameras, ground-truth images, initial Gaussians, scene extent).

This is the reusable core of the reference driver's startup sequence
(main.mm:299-417: loadColmap -> computeSceneExtent -> gaussiansFromColmap ->
loadTrainingData), shared by the train CLI and the GaussianModel facade.
Image decode runs on a thread pool (the reference decodes serially upfront,
image_loader.mm:44-99).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from gaussiansplatting.config import Config
from gaussiansplatting.core.camera import Camera
from gaussiansplatting.core.gaussians import GaussianParams


class Scene(NamedTuple):
    cameras: list        # list[Camera], aligned with gt_images
    gt_images: list      # list[np.ndarray [H, W, 3] float32]
    params: GaussianParams
    extent: float
    resolutions: list    # distinct (W, H) render sizes, most common first


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def load_colmap_scene(
    colmap_dir: str,
    images_dir: str,
    cfg: Config,
    downscale: int = 1,
    capacity: int | None = None,
    capacity_factor: float = 4.0,
    knn_mode: str = "reference",
    decode_workers: int = 8,
) -> Scene:
    from gaussiansplatting.core import camera as camera_mod
    from gaussiansplatting.core import gaussians as gaussians_mod
    from gaussiansplatting.io import colmap as colmap_mod
    from gaussiansplatting.io import images as images_mod
    from gaussiansplatting.io import init as init_mod

    data = colmap_mod.load_colmap(colmap_dir)
    extent = colmap_mod.compute_scene_extent(data, cfg.init.extent_multiplier)

    views = []
    for im in data.images:
        cam_info = data.cameras[im.camera_id]
        path = images_mod.find_image(images_dir, im.name)
        if path is not None:
            views.append((im, cam_info, path))
    if not views:
        raise FileNotFoundError(f"no training images found under {images_dir}")

    def decode(view):
        _, cam_info, path = view
        rw = cam_info.width // downscale
        rh = cam_info.height // downscale
        return images_mod.load_image(path, target_size=(rw, rh))

    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        gts = list(pool.map(decode, views))

    cameras = []
    res_count: dict[tuple, int] = {}
    for im, cam_info, _ in views:
        rw = cam_info.width // downscale
        rh = cam_info.height // downscale
        res_count[(rw, rh)] = res_count.get((rw, rh), 0) + 1
        cameras.append(
            camera_mod.make_camera(
                im.quat_wxyz, im.translation,
                cam_info.fx, cam_info.fy, cam_info.cx, cam_info.cy,
                cam_info.width, cam_info.height,
                render_width=rw, render_height=rh,
                near=cfg.train.near, far=cfg.train.far,
            )
        )

    cloud = init_mod.gaussians_from_points(
        data.points, data.point_colors, extent, cfg.init, knn_mode=knn_mode
    )
    n = cloud.means.shape[0]
    cap = capacity or min(
        cfg.density.max_gaussians,
        max(_next_pow2(int(capacity_factor * n)), 1 << 17),
    )
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities,
        cloud.sh, capacity=cap,
    )
    resolutions = [r for r, _ in sorted(res_count.items(), key=lambda kv: -kv[1])]
    return Scene(
        cameras=cameras, gt_images=gts, params=params,
        extent=extent, resolutions=resolutions,
    )
