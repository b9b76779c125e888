"""End-to-end smoke test of the system on the GPU: the quickest proof that
training and rendering still start and agree with the references.

  python chip_smoke.py               # one card: phases (a) to (e)
  python chip_smoke.py --devices 4   # four cards: phase (f) only

  (a) device: JAX must find a GPU (there is no CPU fallback); prints the
      device kind and count, the JAX version, XLA_FLAGS, the compile-cache
      directory and the card's name and power limit from nvidia-smi.
  (b) blend parity at real widths: one 1297x840 frame (the Mip-NeRF 360
      garden shape) of 150k synthetic Gaussians rendered and
      differentiated with the Pallas-Triton blend and with the XLA blend,
      both in f32; then the ``gpu``-marked kernel tests.
  (c) train step at the reference cap: 1.5M live Gaussians, 1297x840,
      1<<24 pairs; loss finite, overflow and peak memory printed, and
      whether two identical steps give bit-identical parameters.
  (d) trainer CLI: tools/make_dataset writes an 8-view 1297x840 scene with
      150k points into smoke_data/, tools/train trains it at 1.5M capacity
      through one densify/prune event and writes a PLY.
  (e) render CLI: tools/render renders two orbit views of that PLY.
  (f) (--devices 4 only) the tile-sharded step on four cards against the
      single-card step at the phase (c) shape, with pair capacities that
      hold the whole frame on either side.

A failed phase makes the script exit non-zero.  Only when every phase
passed is the last line of standard output one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GARDEN_W, GARDEN_H = 1297, 840       # Mip-NeRF 360 garden at the protocol scale
REF_CAP_GAUSSIANS = 1_500_000        # DensityConfig.max_gaussians
REF_CAP_PAIRS = 1 << 24              # covers the reference's 12M-pair provision
# (f): the single card must hold every pair of the frame (~51M for the
# synthetic scene at the reference cap) and each of four strips its share,
# so that both sides blend exactly the same pairs
SINGLE_PAIRS, STRIP_PAIRS = 1 << 26, 1 << 25
# (f): largest share of Gaussians whose parameters may differ beyond rtol
# 1e-4 / atol 1e-6 after the first Adam step (PERF.md, Findings)
OUT_OF_TOL_MAX = 1e-3
SMOKE_DATA = os.path.join(ROOT, "smoke_data")


def log(msg: str) -> None:
    print(msg, flush=True)


def _scene(n, seed=0):
    import jax.numpy as jnp

    from gaussiansplatting.utils import synthetic

    params = synthetic.make_scene(n, seed=seed)
    cam = synthetic.make_canonical_camera(GARDEN_W, GARDEN_H)
    gt = jnp.asarray(np.random.default_rng(seed + 1).uniform(
        0, 1, (GARDEN_H, GARDEN_W, 3)).astype(np.float32))
    return params, cam, gt


def _peak_gib(device) -> float:
    return device.memory_stats().get("peak_bytes_in_use", 0) / 2**30


def phase_a(cache_dir: str, n_devices: int) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (platform {d.platform!r}, {d.device_kind}); "
            "this smoke test has no CPU fallback"
        )
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, JAX sees {len(devs)}")
    log(f"device_kind: {d.device_kind}  count: {len(devs)}  jax {jax.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache_dir}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        log(line)
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def phase_b() -> None:
    import jax

    from gaussiansplatting.config import LossConfig, RasterConfig
    from gaussiansplatting.ops.losses import photometric_loss
    from gaussiansplatting.ops.rasterize import render
    from gaussiansplatting.train import optimizer

    params, cam, gt = _scene(150_000)
    trainable = {f: getattr(params, f) for f in optimizer.TRAINABLE}
    results = {}
    for impl in ("xla", "auto"):                 # "auto": the kernel on the GPU
        rcfg = RasterConfig(pair_capacity=1 << 23, blend_impl=impl)

        def loss_fn(tr, rcfg=rcfg):
            img, aux = render(params.replace(**tr), cam, rcfg)
            return photometric_loss(img, gt, LossConfig()).grad_loss, (img, aux)

        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            (_, (img, aux)), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(trainable)
            jax.block_until_ready(grads)
        log(f"(b) {impl}: first call {time.perf_counter() - t0:.1f} s, "
            f"pairs {int(aux.num_pairs)}, overflow {bool(aux.overflow)}")
        results[impl] = (np.asarray(img), {k: np.asarray(v) for k, v in grads.items()})
    img_x, g_x = results["xla"]
    img_p, g_p = results["auto"]
    if not (np.isfinite(img_p).all() and all(np.isfinite(v).all() for v in g_p.values())):
        raise RuntimeError("(b) kernel output is not finite")
    diff = np.abs(img_p - img_x)
    rel = {
        k: float(np.linalg.norm(g_p[k] - g_x[k]) / (np.linalg.norm(g_x[k]) + 1e-30))
        for k in g_x
    }
    log(f"(b) image max-abs {diff.max():.3e} (tol 1e-4), pixels > 1e-4: "
        f"{int((diff > 1e-4).sum())} of {diff.size}")
    log(f"(b) gradient relative norm per group (tol 1e-3): {rel}")
    if diff.max() > 1e-4 or max(rel.values()) > 1e-3:
        raise RuntimeError("(b) kernel differs from the XLA blend beyond tolerance")
    _gpu_tests()


def _gpu_tests() -> None:
    import pytest

    saved = dict(os.environ)
    try:
        rc = pytest.main([
            "-q", "-m", "gpu", "-p", "no:cacheprovider",
            os.path.join(ROOT, "tests", "test_pallas_blend.py"),
        ])
    finally:
        # tests/conftest.py sets test-only XLA_FLAGS; JAX's compile-cache
        # keys include XLA_FLAGS, so the later phases must not inherit them
        os.environ.clear()
        os.environ.update(saved)
    log(f"(b) gpu-marked kernel tests: exit code {int(rc)}")
    if rc != 0:
        raise RuntimeError("(b) gpu-marked kernel tests failed")


def phase_c(cache_dir: str) -> None:
    import jax

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.train import optimizer
    from gaussiansplatting.train import state as train_state
    from gaussiansplatting.train.trainer import train_step

    params, cam, gt = _scene(REF_CAP_GAUSSIANS)
    cfg = Config(raster=RasterConfig(pair_capacity=REF_CAP_PAIRS))
    st0 = train_state.create(params)
    n_cache = len(glob.glob(os.path.join(cache_dir, "*")))
    t0 = time.perf_counter()
    st, m = train_step(st0, cam, gt, cfg, 30_000)
    jax.block_until_ready(st)
    first = time.perf_counter() - t0
    log(f"(c) first step (trace + compile or cache load + run): {first:.1f} s; "
        f"cache entries {n_cache} -> {len(glob.glob(os.path.join(cache_dir, '*')))}")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        st, m = train_step(st, cam, gt, cfg, 30_000)
        jax.block_until_ready(st)
        times.append(time.perf_counter() - t0)
    loss = float(m.loss)
    log(f"(c) {REF_CAP_GAUSSIANS} Gaussians, {GARDEN_W}x{GARDEN_H}, "
        f"pair_capacity {REF_CAP_PAIRS}: loss {loss:.6f}, pairs "
        f"{int(m.num_pairs)}, overflow {bool(m.overflow)}, step s {times}, "
        f"peak_bytes_in_use {_peak_gib(jax.devices()[0]):.2f} GiB")
    if not np.isfinite(loss):
        raise RuntimeError("(c) loss is not finite")
    a, _ = train_step(st0, cam, gt, cfg, 30_000)
    b, _ = train_step(st0, cam, gt, cfg, 30_000)
    same = {
        f: bool(np.array_equal(np.asarray(getattr(a.params, f)),
                               np.asarray(getattr(b.params, f))))
        for f in optimizer.TRAINABLE
    }
    log(f"(c) finding: two identical steps give bit-identical parameters: "
        f"{all(same.values())} {same}")


def phase_d() -> str:
    from gaussiansplatting.tools import make_dataset, train

    make_dataset.main([
        "--out", SMOKE_DATA, "--views", "8", "--width", str(GARDEN_W),
        "--height", str(GARDEN_H), "--points", "150000", "--seed", "0",
    ])
    cfg_path = os.path.join(SMOKE_DATA, "density.json")
    with open(cfg_path, "w") as f:
        # one densify + prune event at iteration 15 of 24
        json.dump({"density": {"densify_from_iter": 5, "densify_interval": 15,
                               "grad_threshold": 1e-7}}, f)
    ply = os.path.join(SMOKE_DATA, "smoke.ply")
    metrics = os.path.join(SMOKE_DATA, "metrics.jsonl")
    for p in (ply, metrics):
        if os.path.exists(p):
            os.remove(p)
    train.main([
        "--colmap", os.path.join(SMOKE_DATA, "sparse", "0"),
        "--images", os.path.join(SMOKE_DATA, "images"),
        "--output", ply, "--epochs", "3",
        "--capacity", str(REF_CAP_GAUSSIANS), "--pair-capacity", str(1 << 22),
        "--config", cfg_path,
        "--metrics", metrics,
    ])
    with open(metrics) as f:
        events = [json.loads(line) for line in f]
    n_init = next(e["n_init"] for e in events if e["event"] == "scene")
    n_final = next(e["alive"] for e in events if e["event"] == "export_ply")
    losses = [e["loss"] for e in events if e["event"] == "step"]
    log(f"(d) Gaussians {n_init} -> {n_final}, {len(losses)} steps, last "
        f"loss {losses[-1]:.6f}, PLY {os.path.getsize(ply)} bytes")
    if n_final == n_init:
        raise RuntimeError("(d) the density event changed no Gaussian count")
    if not np.isfinite(losses).all():
        raise RuntimeError("(d) non-finite training loss")
    return ply


def phase_e(ply: str) -> None:
    from gaussiansplatting.io.images import load_image
    from gaussiansplatting.tools import render

    out = os.path.join(SMOKE_DATA, "renders")
    for p in glob.glob(os.path.join(out, "*.png")):
        os.remove(p)
    render.main(["--ply", ply, "--output", out, "--orbit", "2",
                 "--width", str(GARDEN_W), "--height", str(GARDEN_H)])
    pngs = sorted(glob.glob(os.path.join(out, "*.png")))
    if len(pngs) != 2:
        raise RuntimeError(f"(e) expected 2 PNGs, found {pngs}")
    for p in pngs:
        img = load_image(p)
        not_bg = float((np.abs(img - 1.0).max(axis=-1) > 0.02).mean())
        log(f"(e) {os.path.basename(p)}: {img.shape}, finite "
            f"{bool(np.isfinite(img).all())}, non-background share {not_bg:.4f}")
        if img.shape != (GARDEN_H, GARDEN_W, 3) or not np.isfinite(img).all():
            raise RuntimeError(f"(e) bad render {p}")
        if not_bg < 0.01:
            raise RuntimeError(f"(e) {p} is (nearly) pure background")


def phase_f(n_devices: int) -> None:
    import jax

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.parallel import mesh as mesh_mod
    from gaussiansplatting.parallel.sharded import make_sharded_train_step
    from gaussiansplatting.train import optimizer
    from gaussiansplatting.train import state as train_state
    from gaussiansplatting.train.trainer import train_step

    params, cam, gt = _scene(REF_CAP_GAUSSIANS)
    cfg_s = Config(raster=RasterConfig(pair_capacity=STRIP_PAIRS))
    cfg_1 = Config(raster=RasterConfig(pair_capacity=SINGLE_PAIRS))
    mesh = mesh_mod.make_mesh(n_devices)
    st0 = train_state.create(params)
    t0 = time.perf_counter()
    st_s, m_s = make_sharded_train_step(mesh, cfg_s, 30_000)(st0, cam, gt)
    jax.block_until_ready(st_s)
    t_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st_1, m_1 = train_step(st0, cam, gt, cfg_1, 30_000)
    jax.block_until_ready(st_1)
    t_1 = time.perf_counter() - t0
    # the single card against itself: its own run-to-run spread (atomics)
    st_2, _ = train_step(st0, cam, gt, cfg_1, 30_000)
    loss_s, loss_1 = float(m_s.loss), float(m_1.loss)
    rel = abs(loss_s - loss_1) / abs(loss_1)
    log(f"(f) {n_devices}-card step (first call {t_s:.1f} s): loss {loss_s:.7f}, "
        f"pairs {int(m_s.num_pairs)}, overflow {bool(m_s.overflow)}; "
        f"1-card (first call {t_1:.1f} s): loss {loss_1:.7f}, pairs "
        f"{int(m_1.num_pairs)}, overflow {bool(m_1.overflow)}; loss rel {rel:.3e} "
        "(tol 1e-5)")
    if bool(m_s.overflow) or bool(m_1.overflow):
        raise RuntimeError("(f) a pair capacity overflowed: the two sides "
                           "blend different pairs and cannot be compared")
    # The gradients (Adam's first moment is 0.1 * gradient after one step)
    # are compared per group.  The parameters are compared per Gaussian: the
    # first Adam step maps a gradient g to lr * g / (|g| + eps), whose slope
    # reaches lr / eps (2.5e6 for the opacity) where |g| << eps, so the f32
    # reduction noise of a gradient that cancels moves its parameter past
    # atol, and the single card does the same against itself.  Gaussians
    # with any parameter outside rtol 1e-4 / atol 1e-6 are counted for both
    # pairs of runs, and their share is held to OUT_OF_TOL_MAX (PERF.md).
    n = st_1.params.capacity
    failures = []
    for f in optimizer.TRAINABLE:
        ms, m1, m2 = (np.asarray(st.opt.m[f]).reshape(n, -1)
                      for st in (st_s, st_1, st_2))
        rel_g = np.linalg.norm(ms - m1) / (np.linalg.norm(m1) + 1e-30)
        log(f"(f) {f}: gradient relative norm {rel_g:.3e} (tol 1e-3); "
            f"components that change sign: {int((np.sign(ms) != np.sign(m1)).sum())}"
            f" of {m1.size} (single card against itself: "
            f"{int((np.sign(m2) != np.sign(m1)).sum())})")
        if rel_g > 1e-3:
            failures.append(f"{f} gradient")
    out, out_self = np.zeros(n, bool), np.zeros(n, bool)
    for f in optimizer.TRAINABLE:
        ps, p1, p2 = (np.asarray(getattr(st.params, f)).reshape(n, -1)
                      for st in (st_s, st_1, st_2))
        over = np.abs(ps - p1) > 1e-6 + 1e-4 * np.abs(p1)
        out |= over.any(axis=1)
        out_self |= (np.abs(p2 - p1) > 1e-6 + 1e-4 * np.abs(p1)).any(axis=1)
        log(f"(f) {f}: max abs diff {np.abs(ps - p1).max():.3e}, elements "
            f"beyond rtol 1e-4 / atol 1e-6: {int(over.sum())} of {over.size}")
    share = float(out.mean())
    log(f"(f) Gaussians with a parameter beyond rtol 1e-4 / atol 1e-6: "
        f"{int(out.sum())} of {n} ({share:.4%}, bound {OUT_OF_TOL_MAX:.1%}); "
        f"single card against itself: {int(out_self.sum())}")
    if share > OUT_OF_TOL_MAX:
        failures.append("params")
    if not np.isfinite(loss_s) or rel > 1e-5 or failures:
        raise RuntimeError(f"(f) sharded step differs: loss rel {rel}, {failures}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=1, choices=(1, 4),
                   help="4: run only the four-card sharded phase (f)")
    args = p.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    failed = []
    try:
        device = phase_a(cache_dir, args.devices)
    except Exception:
        traceback.print_exc()
        log("(a) FAILED")
        return 1

    if args.devices == 4:
        phases = [("f", lambda: phase_f(4))]
    else:
        ply = []
        phases = [
            ("b", phase_b),
            ("c", lambda: phase_c(cache_dir)),
            ("d", lambda: ply.append(phase_d())),
            ("e", lambda: phase_e(ply[0])),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"({name}) passed in {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc()
            log(f"({name}) FAILED after {time.perf_counter() - t0:.1f} s")
            failed.append(name)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
