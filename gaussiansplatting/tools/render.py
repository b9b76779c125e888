"""Offline renderer CLI — the counterpart of the reference's viewer mode
(``--view path.ply``, main.mm:231-297) and training-view export
(exportTrainingViews, mtl_engine.mm:1224-1306).

There is no interactive window on an accelerator host; instead this renders a PLY
either from an orbit path around the scene (viewer analog) or from the
training cameras of a COLMAP reconstruction (export analog), writing PNG/PPM.

Usage:
  python -m gaussiansplatting.tools.render --ply model.ply --output out/ \
      [--orbit N | --colmap sparse/0] [--width 800 --height 600] [--fov 60]
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", required=True, help="3DGS PLY to render")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--orbit", type=int, default=0, help="render N orbit views")
    p.add_argument("--colmap", default=None, help="render from COLMAP training cameras")
    p.add_argument("--width", type=int, default=None,
                   help="render width (default: 800 for orbit, native camera size for --colmap)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--fov", type=float, default=60.0, help="vertical FoV degrees (orbit)")
    p.add_argument("--elevation", type=float, default=15.0, help="orbit elevation degrees")
    p.add_argument("--radius-scale", type=float, default=1.0)
    p.add_argument("--format", choices=("png", "ppm"), default="png")
    p.add_argument("--gif", default=None,
                   help="additionally write all views as an animated GIF")
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--sh-degree", type=int, default=0, choices=(0, 1),
                   help="0 = reference parity (DC only); 1 = view-dependent color")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os as _os

    if not _os.path.exists(args.ply):
        raise SystemExit(f"error: PLY not found: {args.ply}")
    if args.colmap and not _os.path.isdir(args.colmap):
        raise SystemExit(f"error: COLMAP dir not found: {args.colmap}")

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.core import camera as camera_mod
    from gaussiansplatting.core import gaussians as gaussians_mod
    from gaussiansplatting.io import images as images_mod
    from gaussiansplatting.io import ply as ply_mod
    from gaussiansplatting.ops.rasterize import render as raster_render
    from gaussiansplatting.utils.metrics import MetricsLogger

    cfg = Config(
        raster=RasterConfig(
            pair_capacity=args.pair_capacity, sh_degree=args.sh_degree
        )
    )
    log = MetricsLogger()

    cloud = ply_mod.load_gaussian_ply(args.ply)
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities, cloud.sh
    )
    log.log("load", n_gaussians=cloud.means.shape[0], ply=args.ply)

    os.makedirs(args.output, exist_ok=True)
    render_fn = jax.jit(raster_render, static_argnums=2)

    cameras = []
    names = []
    if args.colmap:
        from gaussiansplatting.io import colmap as colmap_mod

        data = colmap_mod.load_colmap(args.colmap)
        for im in data.images:
            cam_info = data.cameras[im.camera_id]
            # default: native COLMAP resolution, like exportTrainingViews
            # (mtl_engine.mm:1224-1306)
            cameras.append(
                camera_mod.make_camera(
                    im.quat_wxyz,
                    im.translation,
                    cam_info.fx,
                    cam_info.fy,
                    cam_info.cx,
                    cam_info.cy,
                    cam_info.width,
                    cam_info.height,
                    render_width=args.width or cam_info.width,
                    render_height=args.height or cam_info.height,
                )
            )
            names.append(os.path.splitext(im.name)[0])
    else:
        if args.width is None:
            args.width = 800
        if args.height is None:
            args.height = 600
        n_views = args.orbit if args.orbit > 0 else 8
        center = cloud.means.mean(axis=0)
        spread = float(np.percentile(np.linalg.norm(cloud.means - center, axis=1), 90))
        radius = max(spread * 2.5, 1e-3) * args.radius_scale
        fy = args.height / (2.0 * math.tan(math.radians(args.fov) / 2.0))
        for i in range(n_views):
            cameras.append(
                camera_mod.orbit_camera(
                    center,
                    radius,
                    azimuth=2.0 * math.pi * i / n_views,
                    elevation=math.radians(args.elevation),
                    fx=fy,
                    fy=fy,
                    width=args.width,
                    height=args.height,
                )
            )
            names.append(f"orbit_{i:03d}")

    t0 = time.time()
    frames = []
    for cam, name in zip(cameras, names):
        img, aux = render_fn(params, cam, cfg.raster)
        img = np.asarray(img)
        path = os.path.join(args.output, f"{name}.{args.format}")
        if args.format == "png":
            images_mod.save_png(path, img)
        else:
            images_mod.save_ppm(path, img)
        if args.gif:
            frames.append(img)
        log.log("render", view=name, num_pairs=int(aux.num_pairs), path=path)
    if args.gif and frames:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit("error: --gif needs Pillow (PIL), which is not installed")

        pil = [
            Image.fromarray(
                np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
            )
            for f in frames
        ]
        pil[0].save(
            args.gif, save_all=True, append_images=pil[1:], duration=100, loop=0
        )
        log.log("gif", path=args.gif, frames=len(pil))
    dt = time.time() - t0
    log.log("done", views=len(cameras), seconds=round(dt, 2),
            views_per_sec=round(len(cameras) / max(dt, 1e-9), 3))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
