"""Convergence benchmark (BASELINE.md config #3): full training loop, single
chip, no filesystem — a synthetic multi-view scene stands in for a small
COLMAP scene.  Ground truth comes from rendering a hidden target model; the
trained model starts from a perturbed copy and must recover it.

  python -m gaussiansplatting.tools.bench_train [--n 20000] [--views 8]
      [--iters 400] [--width 400 --height 304]

Prints one JSON line with PSNR trajectory and steady-state throughput.
"""

from __future__ import annotations

import argparse
import json
import math
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=304)
    p.add_argument("--pair-capacity", type=int, default=1 << 19)
    p.add_argument("--perturb", type=float, default=0.6)
    # A/B knobs (VERDICT r3 items 8-9): quantify the beyond-reference
    # differentiated D-SSIM and the impact-ordered overflow drop with
    # controlled convergence runs on real hardware.
    p.add_argument("--dssim-in-grad", type=int, default=1, choices=(0, 1),
                   help="1 = differentiate D-SSIM (framework default); "
                        "0 = reference-parity L1-only gradient")
    p.add_argument("--overflow-drop", choices=("index", "impact"),
                   default="index")
    p.add_argument("--eval-views", type=int, default=0,
                   help="hold out this many extra views for PSNR eval "
                        "(never trained on)")
    p.add_argument("--eval-pair-capacity", type=int, default=0,
                   help="pair capacity for eval renders (0 = same as "
                        "training; set higher for capacity-constrained "
                        "overflow A/Bs so eval itself never drops pairs)")
    args = p.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np
    import jax
    import jax.numpy as jnp

    from gaussiansplatting.config import Config, LossConfig, RasterConfig
    from gaussiansplatting.core import camera as camera_mod
    from gaussiansplatting.ops.rasterize import render
    from gaussiansplatting.train import state as state_mod
    from gaussiansplatting.train.trainer import train_step
    from gaussiansplatting.utils import synthetic

    cfg = Config(
        raster=RasterConfig(
            pair_capacity=args.pair_capacity,
            overflow_drop=args.overflow_drop,
        ),
        loss=LossConfig(dssim_in_grad=bool(args.dssim_in_grad)),
    )
    gt_params = synthetic.make_scene(n=args.n, seed=0)

    # ring of cameras around the synthetic box (center ~ (0, 0, 4));
    # held-out eval cameras sit between the training azimuths
    center = np.array([0.0, 0.0, 4.0], np.float32)
    fy = args.height * 1.1

    def ring_cam(az, elev):
        return camera_mod.orbit_camera(
            center, radius=4.0, azimuth=az, elevation=elev,
            fx=fy, fy=fy, width=args.width, height=args.height,
            up=(0.0, -1.0, 0.0),
        )

    cams = [
        ring_cam(2 * math.pi * i / args.views - math.pi / 2,
                 0.25 * math.sin(2.0 * i))
        for i in range(args.views)
    ]
    eval_cams = [
        ring_cam(2 * math.pi * (i + 0.5) / args.views - math.pi / 2,
                 0.25 * math.sin(2.0 * i + 1.0))
        for i in range(args.eval_views)
    ]
    eval_raster = (
        cfg.raster.replace(pair_capacity=args.eval_pair_capacity)
        if args.eval_pair_capacity else cfg.raster
    )
    eval_render = jax.jit(render, static_argnums=2)
    # ALL ground truths (training and held-out) render with the
    # full-capacity eval_raster: in a capacity-constrained overflow A/B the
    # arms must train toward one identical uncorrupted target, with the cap
    # (and the drop policy under test) applied only to the training renders
    # inside train_step (ADVICE r4).
    gts = [eval_render(gt_params, c, eval_raster)[0] for c in cams]
    eval_gts = [eval_render(gt_params, c, eval_raster)[0] for c in eval_cams]

    # perturbed start: same geometry, damaged appearance + jittered positions
    rng = np.random.default_rng(7)
    start = gt_params.replace(
        sh=gt_params.sh
        + jnp.asarray(rng.normal(0, args.perturb, gt_params.sh.shape), jnp.float32),
        raw_opacities=gt_params.raw_opacities
        + jnp.asarray(rng.normal(0, args.perturb, (gt_params.capacity,)), jnp.float32),
        means=gt_params.means
        + jnp.asarray(rng.normal(0, 0.005, gt_params.means.shape), jnp.float32),
    )
    st = state_mod.create(start)

    def mean_psnr(state, cam_list, gt_list, raster):
        vals = []
        for c, g in zip(cam_list, gt_list):
            img, _ = eval_render(state.params, c, raster)
            mse = jnp.mean((img - g) ** 2)
            vals.append(float(-10.0 * jnp.log10(jnp.maximum(mse, 1e-10))))
        return sum(vals) / max(len(vals), 1)

    psnr0 = mean_psnr(st, cams, gts, eval_raster)
    # warmup / compile one step
    st, _ = train_step(st, cams[0], gts[0], cfg, args.iters)
    jax.block_until_ready(st)

    t0 = time.perf_counter()
    # overflow flags stay on device inside the timed loop — a bool() pull
    # is a host sync that drains the async pipeline; summed after
    # block_until_ready instead.
    overflow_flags = []
    for it in range(1, args.iters):
        v = it % args.views
        st, metrics = train_step(st, cams[v], gts[v], cfg, args.iters)
        overflow_flags.append(metrics.overflow)
    jax.block_until_ready(st)
    dt = time.perf_counter() - t0
    # ONE stacked transfer: per-flag np.asarray pulls would pay a host
    # round trip per iteration
    overflow_steps = int(np.asarray(jnp.stack(overflow_flags).sum()))
    psnr1 = mean_psnr(st, cams, gts, eval_raster)
    psnr_holdout = (
        mean_psnr(st, eval_cams, eval_gts, eval_raster)
        if eval_cams else None
    )

    print(
        json.dumps(
            {
                "metric": "train_convergence_synthetic",
                "value": round(psnr1, 2),
                "unit": "dB PSNR",
                "detail": {
                    "psnr_start": round(psnr0, 2),
                    "psnr_end": round(psnr1, 2),
                    "psnr_holdout": (
                        round(psnr_holdout, 2)
                        if psnr_holdout is not None else None
                    ),
                    "iters": args.iters,
                    "views": args.views,
                    "eval_views": args.eval_views,
                    "n_gaussians": args.n,
                    "resolution": [args.width, args.height],
                    "iters_per_sec": round((args.iters - 1) / dt, 2),
                    "dssim_in_grad": bool(args.dssim_in_grad),
                    "overflow_drop": args.overflow_drop,
                    "pair_capacity": args.pair_capacity,
                    "overflow_steps": overflow_steps,
                    "device": str(jax.devices()[0]),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
