"""Training CLI — the counterpart of the reference driver
(main.mm:193-492): load COLMAP, initialize Gaussians from SfM points, train,
export PLY + per-view renders.  Adds what the reference lacks: config files,
checkpoints/resume, JSONL metrics, and multi-chip tile sharding.

Usage (reference flags kept, main.mm:204-228):
  python -m gaussiansplatting.tools.train \
      --colmap scene/sparse/0 --images scene/images --output out.ply \
      [--epochs 155] [--downscale 4] [--checkpoint-dir ckpt/ --resume] \
      [--config cfg.json] [--metrics metrics.jsonl] [--devices N] \
      [--export-renders renders/]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--colmap", required=True, help="COLMAP sparse dir (cameras/images/points3D.bin)")
    p.add_argument("--images", required=True, help="training images dir")
    p.add_argument("--output", default="output.ply", help="output PLY path")
    p.add_argument("--epochs", type=int, default=None, help="override config epochs")
    p.add_argument("--downscale", type=int, default=1, help="image downscale factor")
    p.add_argument("--config", default=None, help="config JSON (defaults = reference constants)")
    p.add_argument("--capacity", type=int, default=None, help="Gaussian capacity (default: grows to density cap)")
    p.add_argument("--pair-capacity", type=int, default=None,
                   help="padded (tile,depth) pairs per frame (default 1<<21; "
                        "on --resume, None keeps the checkpoint's value)")
    p.add_argument("--chunk-slack", type=float, default=None,
                   help="expansion chunk-padding allowance scale (1.0 = "
                        "worst case; 0.5 cuts fat-sort rows ~20%% at "
                        "reference scale, overflow path covers undersizing)")
    p.add_argument("--overflow-drop", choices=("index", "impact"), default=None,
                   help="which Gaussians lose pairs on overflow: 'index' = "
                        "emission-order prefix (reference parity, "
                        "tiled_shaders.metal:779-780), 'impact' = keep the "
                        "highest opacity*tiles set (better under chronic "
                        "overflow at a capped capacity)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-interval", type=int, default=5000, help="iters between checkpoints (0=end only)")
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint in --checkpoint-dir")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--devices", type=int, default=1, help="shard tiles across N devices")
    p.add_argument("--export-renders", default=None, help="dir for final per-view renders")
    p.add_argument("--knn-mode", choices=("reference", "exact"), default="reference")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator host:port (jax.distributed)")
    p.add_argument("--snapshot-dir", default=None,
                   help="write render+gt PNG snapshots every config snapshot_interval iters")
    p.add_argument("--sh-degree", type=int, default=None, choices=(0, 1),
                   help="override config SH degree (1 = trainable view-dependent color)")
    p.add_argument("--adaptive-pairs", action="store_true",
                   help="auto-bucket pair capacity to the live workload "
                        "(--pair-capacity becomes the upper bound)")
    p.add_argument("--adaptive-capacity", action="store_true",
                   help="start the Gaussian arrays near the SfM point count "
                        "and grow them with densification (--capacity "
                        "becomes the upper bound)")
    p.add_argument("--min-pair-capacity", type=int, default=1 << 16,
                   help="adaptive-pairs lower bound; set near the expected "
                        "initial workload to skip the overflow ramp-up")
    p.add_argument("--batch-views", type=int, default=1, metavar="K",
                   help="one Adam step on the mean gradient of K views "
                        "(larger effective batch; 1 = reference parity)")
    p.add_argument("--shuffle", action="store_true",
                   help="shuffle view order each epoch (official-3DGS style; "
                        "default keeps the reference's fixed order)")
    p.add_argument("--scan-steps", type=int, default=1, metavar="K",
                   help="dispatch K consecutive steps as one compiled "
                        "program when no schedule event falls inside "
                        "(amortizes per-step host dispatch; pick a divisor "
                        "of the densify/snapshot cadence, e.g. 10 or 25)")
    p.add_argument("--eval-split", type=int, default=0, metavar="N",
                   help="hold out every Nth view from training and report "
                        "held-out PSNR/L1 at the end (official-3DGS style; 0 = off)")
    return p


def apply_raster_overrides(raster, args, default_pair_capacity=None):
    """CLI flags win over config/checkpoint values; an OMITTED flag keeps
    them (the default must not silently shrink a config's capacity).
    ``default_pair_capacity`` applies only when neither flag nor config
    source provided one (fresh start without --config)."""
    if args.pair_capacity is not None:
        raster = raster.replace(pair_capacity=args.pair_capacity)
    elif default_pair_capacity is not None:
        raster = raster.replace(pair_capacity=default_pair_capacity)
    if args.sh_degree is not None:
        raster = raster.replace(sh_degree=args.sh_degree)
    if args.overflow_drop is not None:
        raster = raster.replace(overflow_drop=args.overflow_drop)
    if args.chunk_slack is not None:
        raster = raster.replace(chunk_slack=args.chunk_slack)
    return raster


def load_scene(args, cfg):
    """COLMAP -> (cameras, gt_images, initial params, scene_extent)."""
    from gaussiansplatting.io.dataset import load_colmap_scene

    try:
        scene = load_colmap_scene(
            args.colmap, args.images, cfg,
            downscale=args.downscale,
            capacity=None if args.adaptive_capacity else args.capacity,
            capacity_factor=1.5 if args.adaptive_capacity else 4.0,
            knn_mode=args.knn_mode,
        )
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}")
    if len(scene.resolutions) > 1:
        print(
            f"warning: {len(scene.resolutions)} distinct render resolutions "
            f"{scene.resolutions[:4]} — each compiles its own train step"
        )
    return scene.cameras, scene.gt_images, scene.params, scene.extent


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os as _os

    if not _os.path.isdir(args.colmap):
        raise SystemExit(f"error: COLMAP dir not found: {args.colmap}")
    if not _os.path.isdir(args.images):
        raise SystemExit(f"error: images dir not found: {args.images}")
    if args.config and not _os.path.exists(args.config):
        raise SystemExit(f"error: config not found: {args.config}")

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    from gaussiansplatting.config import Config
    from gaussiansplatting.io import images as images_mod
    from gaussiansplatting.io import ply as ply_mod
    from gaussiansplatting.ops.rasterize import render as raster_render
    from gaussiansplatting.train import checkpoint as ckpt_mod
    from gaussiansplatting.train import state as state_mod
    from gaussiansplatting.train import trainer
    from gaussiansplatting.utils.metrics import MetricsLogger

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    # a config JSON's pair_capacity is authoritative when the flag is
    # omitted; without either, default 1<<21
    cfg = cfg.replace(raster=apply_raster_overrides(
        cfg.raster, args,
        default_pair_capacity=None if args.config else 1 << 21,
    ))

    from gaussiansplatting.parallel import launch

    topo = launch.initialize(coordinator=args.coordinator)
    # Multi-host discipline: every process executes the same SPMD compute
    # (jit/shard_map must run on all hosts), but only process 0 touches the
    # filesystem — metrics, checkpoints, snapshots, and exports land on a
    # shared FS exactly once instead of once per host.
    primary = launch.is_primary()
    log = MetricsLogger(path=args.metrics if primary else None, echo=primary)
    log.log("start", colmap=args.colmap, devices=args.devices, **topo)

    if args.metrics:
        # the JSONL stream records every step; the console echo line costs
        # ~4 device->host round trips
        cfg = cfg.replace(train=cfg.train.replace(
            log_interval=max(cfg.train.log_interval, 100)))

    cameras, gts, params, extent = load_scene(args, cfg)
    eval_cams, eval_gts = [], []
    if args.eval_split > 1:
        train_cams, train_gts = [], []
        for i, (c, g) in enumerate(zip(cameras, gts)):
            if i % args.eval_split == 0:
                eval_cams.append(c)
                eval_gts.append(g)
            else:
                train_cams.append(c)
                train_gts.append(g)
        cameras, gts = train_cams, train_gts
    log.log(
        "scene",
        views=len(cameras),
        eval_views=len(eval_cams),
        n_init=int(np.asarray(params.alive).sum()),
        capacity=params.capacity,
        extent=round(extent, 4),
        resolution=[cameras[0].width, cameras[0].height],
    )

    latest = (
        os.path.join(args.checkpoint_dir, "latest.npz") if args.checkpoint_dir else None
    )
    if args.resume and latest and os.path.exists(latest):
        state, saved_cfg = ckpt_mod.load(latest)
        if saved_cfg is not None:
            cfg = saved_cfg
            # CLI overrides win over the checkpoint's saved config (raising
            # --pair-capacity on resume must actually take effect); omitted
            # flags keep the checkpoint's values
            cfg = cfg.replace(raster=apply_raster_overrides(cfg.raster, args))
        log.log("resume", path=latest, iteration=int(state.opt.t))
    else:
        state = state_mod.create(params, seed=cfg.train.seed)

    if topo["process_count"] > 1:
        # Write-once checkpoints assume a SHARED filesystem (process 0
        # writes, everyone reads).  If hosts disagree on the resume point
        # (e.g. local disks: only host 0 finds latest.npz), the SPMD loop
        # would silently mix divergent state — fail loudly instead.
        from jax.experimental import multihost_utils

        multihost_utils.assert_equal(
            np.int64(int(state.opt.t)),
            "resume iteration differs across hosts: checkpoints must live "
            "on a shared filesystem (only process 0 writes them)",
        )

    gts = [jax.device_put(g) for g in gts]

    # Per-step metrics stay ON DEVICE and flush in batches: each host read
    # waits for the device, so per-step float() casts (10 scalars/step)
    # would serialise host and device.  One jnp.stack per step (async
    # dispatch) + one transfer per FLUSH steps is ~free.
    import jax.numpy as jnp

    _buf: list = []
    _FLUSH = 25

    def _flush_metrics():
        if not _buf:
            return
        iters = [it for it, _ in _buf]
        vals = np.asarray(jnp.stack([v for _, v in _buf]))
        _buf.clear()
        for it, row in zip(iters, vals):
            if not np.isfinite(row[0]):
                log.log("warning", iter=it,
                        msg="non-finite loss — check LRs / pair capacity")
            log.log(
                "step", iter=it,
                loss=float(row[0]), l1=float(row[1]), dssim=float(row[2]),
                psnr=float(row[3]), n=int(row[4]), pairs=int(row[5]),
                overflow=bool(row[6] > 0), lr_pos=float(row[7]),
                mean_op=round(float(row[8]), 4),
                mean_scale=round(float(row[9]), 5),
            )

    def metrics_fn(iteration, metrics):
        if not primary:
            # secondaries would stack + pull + format + discard (their
            # logger has no file and no echo) — skip the device sync per
            # flush; the stack/pull is a host read, not SPMD
            return
        vec = jnp.stack([
            metrics.loss, metrics.l1, metrics.dssim, metrics.psnr,
            metrics.num_gaussians.astype(jnp.float32),
            metrics.num_pairs.astype(jnp.float32),
            metrics.overflow.astype(jnp.float32),
            metrics.position_lr, metrics.mean_opacity,
            metrics.mean_world_scale,
        ])
        _buf.append((iteration, vec))
        if len(_buf) >= _FLUSH:
            _flush_metrics()

    def checkpoint_fn(iteration, st):
        if latest and primary:
            ckpt_mod.save(latest, st, cfg)
            log.log("checkpoint", iter=iteration, path=latest)

    def snapshot_fn(iteration, st, cam, gt):
        # render on every process (SPMD), write on the primary only
        img, _ = jax.jit(raster_render, static_argnums=2)(st.params, cam, cfg.raster)
        if not primary:
            return
        os.makedirs(args.snapshot_dir, exist_ok=True)
        images_mod.save_png(
            os.path.join(args.snapshot_dir, f"render_{iteration:06d}.png"),
            np.asarray(img),
        )
        images_mod.save_png(
            os.path.join(args.snapshot_dir, f"gt_{iteration:06d}.png"),
            np.asarray(gt),
        )
        log.log("snapshot", iter=iteration, dir=args.snapshot_dir)

    epochs = args.epochs if args.epochs is not None else cfg.train.epochs
    t0 = time.time()
    state = trainer.train_loop(
        state, cameras, gts, cfg, extent,
        num_epochs=epochs,
        log_fn=lambda msg: log.log("info", msg=msg),
        metrics_fn=metrics_fn,
        checkpoint_fn=checkpoint_fn if args.checkpoint_dir else None,
        checkpoint_interval=args.checkpoint_interval,
        mesh_devices=args.devices,
        snapshot_fn=snapshot_fn if args.snapshot_dir else None,
        shuffle_seed=cfg.train.seed if args.shuffle else None,
        batch_views=args.batch_views,
        adaptive_pairs=args.adaptive_pairs,
        min_pair_capacity=args.min_pair_capacity,
        adaptive_capacity=args.adaptive_capacity,
        max_capacity=args.capacity,
        scan_steps=args.scan_steps,
    )
    _flush_metrics()
    log.log("trained", seconds=round(time.time() - t0, 1), iteration=int(state.opt.t))

    if args.checkpoint_dir:
        checkpoint_fn(int(state.opt.t), state)

    # held-out evaluation (no reference equivalent; official-3DGS test split)
    if eval_cams:
        render_jit = jax.jit(raster_render, static_argnums=2)
        psnrs = []
        for c, g in zip(eval_cams, eval_gts):
            img, _ = render_jit(state.params, c, cfg.raster)
            mse = float(np.mean((np.asarray(img) - np.asarray(g)) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        log.log(
            "eval",
            views=len(psnrs),
            psnr=round(sum(psnrs) / len(psnrs), 3),
            psnr_min=round(min(psnrs), 3),
        )

    # export PLY (reference: PLYExporter::exportPLY, main.mm:408-418);
    # write-once on the primary host
    if primary:
        count = int(np.asarray(state.params.alive).sum())
        cloud = ply_mod.cloud_from_params(state.params)
        n_written = ply_mod.export_gaussian_ply(args.output, cloud)
        log.log("export_ply", path=args.output, n=n_written, alive=count)

    # export per-view renders (reference: exportTrainingViews); renders run
    # on every process (SPMD), files land on the primary
    if args.export_renders:
        if primary:
            os.makedirs(args.export_renders, exist_ok=True)
        render_fn = jax.jit(raster_render, static_argnums=2)
        for i, cam in enumerate(cameras):
            img, _ = render_fn(state.params, cam, cfg.raster)
            if primary:
                images_mod.save_png(
                    os.path.join(args.export_renders, f"view_{i:04d}.png"),
                    np.asarray(img),
                )
        log.log("export_renders", dir=args.export_renders, views=len(cameras))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
