"""Benchmark: full differentiable train step (project -> pair expand -> sort
-> tile blend -> loss -> backward -> Adam) on one GPU, synthetic scene.

  python bench.py            # 100k Gaussians, 800x608, 1<<21 pairs
  GS_BENCH_SMALL=1 python bench.py

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

The headline value is the MEDIAN of several timing windows of
``train_steps`` (K steps in one device program); every window is reported
in detail, with the device (platform, kind, count), XLA_FLAGS and the
card's name and power limit from nvidia-smi.  The script fails when JAX
finds no GPU: a number from another backend is not a device number.

Baseline anchor: the reference itself publishes no numbers (BASELINE.md).
Official 3DGS (Kerbl et al. 2023, Table 1) trains garden for 30k iters in
~36 min on an RTX A6000 at 1297x840 (~1.09 Mpix) — ~14 iters/s, i.e. ~31
iters/s scaled to this workload's 0.49 Mpix.  The reference's own Metal
pipeline is structurally slower (>=6 blocking command buffers per step plus
a CPU radix sort, tiled_rasterizer.mm:27-102, SURVEY.md §3.2);
BASELINE_ITERS_PER_SEC = 10 is that official rate scaled by ~1/3 for
Apple-silicon bandwidth and compute.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

BASELINE_ITERS_PER_SEC = 10.0


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def device_record() -> dict:
    """Platform, kind and count of the devices JAX sees; exits unless
    they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {devs[0].platform!r} "
            f"({devs[0].device_kind})"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "nvidia_smi": nvidia_smi(),
    }


def main() -> None:
    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    small = bool(int(os.environ.get("GS_BENCH_SMALL", "0")))
    n_gauss = 10_000 if small else 100_000
    width, height = (256, 192) if small else (800, 608)
    pair_cap = (1 << 17) if small else (1 << 21)
    steps = 5 if small else 8

    import jax
    import jax.numpy as jnp

    device = device_record()

    from gaussiansplatting.config import Config, LossConfig, RasterConfig
    from gaussiansplatting.ops.rasterize import _use_kernel
    from gaussiansplatting.train import state as train_state
    from gaussiansplatting.train.trainer import train_step, train_steps
    from gaussiansplatting.utils import sol, synthetic

    # Reference-gradient parity: the Metal trainer this bench compares
    # against backpropagates pure L1 and uses D-SSIM only as a reported
    # metric (tiled_shaders.metal:417-423) — so the benchmarked step does
    # the same.  GS_BENCH_DSSIM_GRAD=1 measures the beyond-reference mode
    # (differentiated D-SSIM, the framework default for training quality).
    dssim_in_grad = bool(int(os.environ.get("GS_BENCH_DSSIM_GRAD", "0")))
    cfg = Config(
        raster=RasterConfig(pair_capacity=pair_cap, pair_block=128),
        loss=LossConfig(dssim_in_grad=dssim_in_grad),
    )
    params = synthetic.make_scene(n=n_gauss, seed=0)
    camera = synthetic.make_canonical_camera(width=width, height=height)
    gt = np.asarray(
        np.random.default_rng(1).uniform(0, 1, (height, width, 3)), np.float32
    )

    st = train_state.create(params)
    t0 = time.perf_counter()
    st, metrics = train_step(st, camera, gt, cfg, 30_000)
    jax.block_until_ready(st)

    # The timed unit is the framework's real training dispatch: train_steps
    # scans `steps` optimization steps (one per view) into ONE device
    # program, exactly as train_loop(scan_steps=...) dispatches between
    # schedule events.
    cams_k = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *([camera] * steps)
    )
    gts_k = jnp.broadcast_to(jnp.asarray(gt), (steps,) + gt.shape)
    st, ms = train_steps(st, cams_k, gts_k, cfg, 30_000)
    metrics = jax.tree_util.tree_map(lambda x: x[-1], ms)
    jax.block_until_ready(st)
    setup_s = time.perf_counter() - t0

    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        st, ms = train_steps(st, cams_k, gts_k, cfg, 30_000)
        jax.block_until_ready(st)
        windows.append(steps / (time.perf_counter() - t0))

    srt = sorted(windows)
    median_ips = srt[len(srt) // 2]
    best_ips = srt[-1]

    # distance to speed of light (utils/sol.py): single-touch bytes + f32
    # flops at the dispatched static shapes vs the best window
    m = sol.step_model(n_gauss, pair_cap, height, width, device["kind"])
    step_ms = 1e3 / best_ips
    sol_detail = {
        "hbm_gbps_achieved": m["bytes_total"] / step_ms / 1e6,
        "model_bound_fraction": m["floor_ms"] / step_ms,
        "floor_ms_single_touch": m["floor_ms"],
        "peak_source": m["peak_source"],
    }

    # per-stage split, OPT-IN (GS_BENCH_STAGES=1): it compiles three more
    # full-size programs, and differently-pruned cumulative probes are only
    # indicative; tools/trace.py is the per-op profiler
    stages = {}
    if not small and bool(int(os.environ.get("GS_BENCH_STAGES", "0"))):
        from gaussiansplatting.tools.profile import stage_times

        stages = stage_times(
            n=n_gauss, width=width, height=height,
            pair_capacity=pair_cap, pair_block=128,
            names=("project_pairs", "forward", "train_step"),
        )

    record = {
        "metric": f"train_step_iters_per_sec_{n_gauss // 1000}k_{width}x{height}",
        "value": median_ips,
        "unit": "iters/s",
        "vs_baseline": median_ips / BASELINE_ITERS_PER_SEC,
        "detail": {
            "device": device,
            "n_gaussians": n_gauss,
            "resolution": [width, height],
            "pair_capacity": pair_cap,
            "blend": "pallas" if _use_kernel(cfg.raster.blend_impl) else "xla",
            "train_mpix_per_sec": median_ips * width * height / 1e6,
            "best_iters_per_sec": best_ips,
            "scan_steps": steps,
            "windows": windows,
            "setup_seconds_incl_compile": setup_s,
            "num_pairs": int(metrics.num_pairs),
            "overflow": bool(metrics.overflow),
            "dssim_in_grad": dssim_in_grad,
            "stages_ms_cumulative": stages,
            "speed_of_light": sol_detail,
            "peak_bytes_in_use": jax.devices()[0].memory_stats().get(
                "peak_bytes_in_use"
            ),
        },
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
