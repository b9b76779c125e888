"""Evaluation CLI: render a trained model from its training cameras and score
PSNR / SSIM / L1 against the ground-truth images.

The reference has no quantitative evaluation at all (its only check is
eyeballing exported PPMs, SURVEY.md §4); this closes BASELINE.md config #4's
"train to reference PSNR" measurement loop.

  python -m gaussiansplatting.tools.evaluate --ply out.ply \
      --colmap scene/sparse/0 --images scene/images [--downscale 4]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", required=True)
    p.add_argument("--colmap", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--sh-degree", type=int, default=0, choices=(0, 1))
    p.add_argument("--metrics", default=None, help="JSONL output path")
    args = p.parse_args(argv)
    import os as _os

    if not _os.path.exists(args.ply):
        raise SystemExit(f"error: PLY not found: {args.ply}")
    if not _os.path.isdir(args.colmap):
        raise SystemExit(f"error: COLMAP dir not found: {args.colmap}")

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np
    import jax

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.core import camera as camera_mod
    from gaussiansplatting.core import gaussians as gaussians_mod
    from gaussiansplatting.io import colmap as colmap_mod
    from gaussiansplatting.io import images as images_mod
    from gaussiansplatting.io import ply as ply_mod
    from gaussiansplatting.ops.losses import psnr as psnr_fn
    from gaussiansplatting.ops.rasterize import render
    from gaussiansplatting.ops.ssim import dssim_map
    from gaussiansplatting.utils.metrics import MetricsLogger

    cfg = Config(
        raster=RasterConfig(
            pair_capacity=args.pair_capacity, sh_degree=args.sh_degree
        )
    )
    log = MetricsLogger(path=args.metrics)

    cloud = ply_mod.load_gaussian_ply(args.ply)
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities, cloud.sh
    )
    data = colmap_mod.load_colmap(args.colmap)
    render_fn = jax.jit(render, static_argnums=2)

    rows = []
    for im in data.images:
        cam_info = data.cameras[im.camera_id]
        path = images_mod.find_image(args.images, im.name)
        if path is None:
            continue
        rw = cam_info.width // args.downscale
        rh = cam_info.height // args.downscale
        gt = images_mod.load_image(path, target_size=(rw, rh))
        cam = camera_mod.make_camera(
            im.quat_wxyz, im.translation,
            cam_info.fx, cam_info.fy, cam_info.cx, cam_info.cy,
            cam_info.width, cam_info.height,
            render_width=rw, render_height=rh,
        )
        img, _ = render_fn(params, cam, cfg.raster)
        img = np.asarray(img)
        view_psnr = float(psnr_fn(img, gt))
        view_ssim = 1.0 - 2.0 * float(np.mean(np.asarray(dssim_map(img, gt))))
        view_l1 = float(np.mean(np.abs(img - gt)))
        rows.append((im.name, view_psnr, view_ssim, view_l1))
        log.log("view", name=im.name, psnr=round(view_psnr, 3),
                ssim=round(view_ssim, 4), l1=round(view_l1, 5))

    if not rows:
        raise SystemExit(f"no evaluable views under {args.images}")
    mean_psnr = sum(r[1] for r in rows) / len(rows)
    mean_ssim = sum(r[2] for r in rows) / len(rows)
    mean_l1 = sum(r[3] for r in rows) / len(rows)
    summary = {
        "metric": "eval",
        "views": len(rows),
        "psnr": round(mean_psnr, 3),
        "ssim": round(mean_ssim, 4),
        "l1": round(mean_l1, 5),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
