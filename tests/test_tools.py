"""Checkpoint/resume, metrics logging, orbit camera, and end-to-end CLI tests
(SURVEY.md §5: checkpoint + observability rows; §2 CLI/driver row)."""

import json
import math
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplatting.config import Config, RasterConfig, TrainConfig
from gaussiansplatting.core import camera as camera_mod
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.core.transforms import quat_to_rotmat
from gaussiansplatting.ops.rasterize import render
from gaussiansplatting.train import checkpoint as ckpt_mod
from gaussiansplatting.train import state as state_mod
from gaussiansplatting.train import trainer
from gaussiansplatting.utils.metrics import MetricsLogger
from gaussiansplatting.utils import synthetic

from conftest import make_camera_for_scene, make_scene
from test_io import write_cameras_bin, write_images_bin, write_points_bin


def _cfg():
    return Config(raster=RasterConfig(pair_capacity=2048, pair_block=16))


def _params(rng, n=48):
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return G.from_arrays(means, log_scales, quats, raw_op, sh)


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path, rng):
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=48)
    gt = jnp.zeros((48, 64, 3), jnp.float32)
    st = state_mod.create(_params(rng), seed=7)
    st, _ = trainer.train_step(st, cam, gt, cfg, 100)

    path = str(tmp_path / "ckpt.npz")
    ckpt_mod.save(path, st, cfg)
    loaded, loaded_cfg = ckpt_mod.load(path)

    assert loaded_cfg == cfg
    for (p1, a), (p2, b) in zip(
        jax.tree_util.tree_flatten_with_path(st)[0],
        jax.tree_util.tree_flatten_with_path(loaded)[0],
    ):
        assert jax.tree_util.keystr(p1) == jax.tree_util.keystr(p2)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_is_bit_exact(tmp_path, rng):
    """save -> load -> N more steps == N+M straight steps."""
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=48)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st_a = state_mod.create(_params(np.random.default_rng(3)), seed=1)
    for _ in range(3):
        st_a, _ = trainer.train_step(st_a, cam, gt, cfg, 100)

    path = str(tmp_path / "mid.npz")
    ckpt_mod.save(path, st_a, cfg)
    st_b, _ = ckpt_mod.load(path)

    for _ in range(2):
        st_a, _ = trainer.train_step(st_a, cam, gt, cfg, 100)
        st_b, _ = trainer.train_step(st_b, cam, gt, cfg, 100)

    np.testing.assert_array_equal(
        np.asarray(st_a.params.means), np.asarray(st_b.params.means)
    )
    np.testing.assert_array_equal(
        np.asarray(st_a.opt.m["means"]), np.asarray(st_b.opt.m["means"])
    )
    assert int(st_a.opt.t) == int(st_b.opt.t)


def test_checkpoint_rejects_newer_format(tmp_path, rng):
    st = state_mod.create(_params(rng))
    path = str(tmp_path / "c.npz")
    ckpt_mod.save(path, st)
    # corrupt the version
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["format_version"] = 99
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="newer"):
        ckpt_mod.load(path)


# ------------------------------------------------------------------- metrics

def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path=path, echo=False) as log:
        log.log("step", iter=1, loss=0.5)
        log.log("step", iter=2, loss=np.float32(0.25), n=np.int32(7))
    lines = [json.loads(l) for l in open(path)]
    assert [l["event"] for l in lines] == ["step", "step"]
    assert lines[1]["loss"] == 0.25 and lines[1]["n"] == 7


# -------------------------------------------------------------- orbit camera

def test_look_at_view_is_rotation_and_faces_target():
    R, t = camera_mod.look_at_view([0, 0, -5], [0, 0, 0], up=(0, -1, 0))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-6)
    # target projects onto +z axis at distance 5
    cam_target = R @ np.array([0.0, 0.0, 0.0]) + t
    np.testing.assert_allclose(cam_target, [0, 0, 5], atol=1e-6)


def test_orbit_camera_keeps_center_in_view(rng):
    params = _params(rng)
    center = np.asarray(params.means[:48].mean(axis=0))
    cfg = _cfg()
    for az in (0.0, 1.7, 3.9):
        cam = camera_mod.orbit_camera(
            center, radius=3.0, azimuth=az, elevation=0.3,
            fx=80.0, fy=80.0, width=64, height=64,
        )
        # the scene center must land near the image center
        c_cam = np.asarray(cam.view[:3, :3]) @ center + np.asarray(cam.view[:3, 3])
        assert c_cam[2] == pytest.approx(3.0, abs=1e-5)
        sx = 80.0 * c_cam[0] / c_cam[2] + 32.0
        sy = 80.0 * c_cam[1] / c_cam[2] + 32.0
        assert abs(sx - 32.0) < 1.0 and abs(sy - 32.0) < 1.0
        img, aux = jax.jit(render, static_argnums=2)(params, cam, cfg.raster)
        assert int(aux.num_pairs) > 0
        assert np.isfinite(np.asarray(img)).all()


def test_rotmat_quat_roundtrip(rng):
    for _ in range(10):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        R = np.asarray(quat_to_rotmat(jnp.asarray(q)))
        q2 = camera_mod.rotmat_to_quat_wxyz(R)
        # q and -q are the same rotation
        assert min(np.abs(q - q2).max(), np.abs(q + q2).max()) < 1e-5


# ------------------------------------------------------- end-to-end CLI flow

@pytest.fixture
def tiny_scene_dir(tmp_path, rng):
    """A 2-view synthetic COLMAP scene with images rendered from a known
    Gaussian cloud, so CLI training has signal."""
    from gaussiansplatting.io import images as images_mod

    sparse = tmp_path / "sparse"
    images = tmp_path / "images"
    sparse.mkdir()
    images.mkdir()

    w = h = 64
    fx = fy = 76.8
    write_cameras_bin(str(sparse / "cameras.bin"), [(1, 1, w, h, [fx, fy, w / 2, h / 2])])
    # identity pose + slight x offset pose
    q = [1.0, 0.0, 0.0, 0.0]
    write_images_bin(
        str(sparse / "images.bin"),
        [(1, q, [0.0, 0.0, 0.0], 1, "v0.png", 0), (2, q, [0.15, 0.0, 0.0], 1, "v1.png", 0)],
    )
    pts = []
    means, *_ = make_scene(rng, n=40, spread=0.6)
    for i, p in enumerate(means):
        rgb = rng.integers(0, 255, 3)
        pts.append((i, list(map(float, p)), list(map(int, rgb)), 0.5, 0))
    write_points_bin(str(sparse / "points3D.bin"), pts)

    gt_params = _params(rng, n=40)
    for name, tx in (("v0.png", 0.0), ("v1.png", 0.15)):
        cam = camera_mod.make_camera(q, [tx, 0, 0], fx, fy, w / 2, h / 2, w, h)
        img, _ = jax.jit(render, static_argnums=2)(gt_params, cam, _cfg().raster)
        images_mod.save_png(str(images / name), np.asarray(img))

    from gaussiansplatting.io import ply as ply_mod

    ply_mod.export_gaussian_ply(
        str(tmp_path / "gt.ply"), ply_mod.cloud_from_params(gt_params)
    )
    return tmp_path


@pytest.mark.slow
def test_train_cli_end_to_end(tiny_scene_dir, tmp_path):
    from gaussiansplatting.tools import train as train_cli
    from gaussiansplatting.io import ply as ply_mod

    out_ply = str(tmp_path / "out.ply")
    metrics = str(tmp_path / "metrics.jsonl")
    ckdir = str(tmp_path / "ck")
    cfg_path = str(tmp_path / "cfg.json")
    cfg = Config(
        raster=RasterConfig(pair_capacity=2048, pair_block=16),
        train=TrainConfig(epochs=2, log_interval=100),
    )
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())

    rc = train_cli.main([
        "--colmap", str(tiny_scene_dir / "sparse"),
        "--images", str(tiny_scene_dir / "images"),
        "--output", out_ply,
        "--config", cfg_path,
        "--capacity", "64",
        "--pair-capacity", "2048",
        "--checkpoint-dir", ckdir,
        "--checkpoint-interval", "2",
        "--metrics", metrics,
        "--export-renders", str(tmp_path / "renders"),
    ])
    assert rc == 0
    cloud = ply_mod.load_gaussian_ply(out_ply)
    assert cloud.means.shape[0] == 40
    lines = [json.loads(l) for l in open(metrics)]
    events = {l["event"] for l in lines}
    assert {"start", "scene", "step", "checkpoint", "export_ply"} <= events
    steps = [l for l in lines if l["event"] == "step"]
    assert len(steps) == 4  # 2 epochs x 2 views
    assert (tmp_path / "renders" / "view_0000.png").exists()
    assert (tmp_path / "ck" / "latest.npz").exists()

    # resume continues from the checkpoint
    rc = train_cli.main([
        "--colmap", str(tiny_scene_dir / "sparse"),
        "--images", str(tiny_scene_dir / "images"),
        "--output", out_ply,
        "--config", cfg_path,
        "--capacity", "64",
        "--pair-capacity", "2048",
        "--checkpoint-dir", ckdir,
        "--resume",
        "--epochs", "1",
        "--metrics", metrics,
    ])
    assert rc == 0
    lines = [json.loads(l) for l in open(metrics)]
    resume = [l for l in lines if l["event"] == "resume"]
    assert resume and resume[0]["iteration"] == 4


def test_render_cli_orbit(tiny_scene_dir, tmp_path, rng):
    from gaussiansplatting.tools import render as render_cli
    from gaussiansplatting.io import ply as ply_mod

    cloud = ply_mod.cloud_from_params(_params(rng, n=40))
    ply_path = str(tmp_path / "model.ply")
    ply_mod.export_gaussian_ply(ply_path, cloud)

    outdir = str(tmp_path / "orbit")
    rc = render_cli.main([
        "--ply", ply_path, "--output", outdir, "--orbit", "3",
        "--width", "64", "--height", "64", "--pair-capacity", "2048",
    ])
    assert rc == 0
    import os
    files = sorted(os.listdir(outdir))
    assert files == ["orbit_000.png", "orbit_001.png", "orbit_002.png"]


def test_evaluate_cli(tiny_scene_dir, tmp_path):
    from gaussiansplatting.tools import evaluate as eval_cli

    ply_path = str(tiny_scene_dir / "gt.ply")
    metrics = str(tmp_path / "eval.jsonl")
    rc = eval_cli.main([
        "--ply", ply_path,
        "--colmap", str(tiny_scene_dir / "sparse"),
        "--images", str(tiny_scene_dir / "images"),
        "--pair-capacity", "2048",
        "--metrics", metrics,
    ])
    assert rc == 0
    lines = [json.loads(l) for l in open(metrics)]
    views = [l for l in lines if l["event"] == "view"]
    assert len(views) == 2
    # the PLY was written from the same cloud the GT images were rendered
    # with, so reconstruction should be near-perfect
    assert all(v["psnr"] > 30 for v in views)


@pytest.mark.slow
def test_bench_train_cli_smoke():
    """The convergence benchmark runs end to end at toy scale."""
    import contextlib
    import io as _io

    from gaussiansplatting.tools import bench_train

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_train.main([
            "--n", "64", "--views", "2", "--iters", "4",
            "--width", "64", "--height", "48", "--pair-capacity", "2048",
        ])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["metric"] == "train_convergence_synthetic"
    assert out["detail"]["iters"] == 4


def test_profiling_loop_time_ms_smoke():
    from gaussiansplatting.utils.profiling import loop_time_ms

    def f(x):
        return x * 1.0000001 + 1e-9

    ms = loop_time_ms(f, (jnp.ones((128, 128)),), k_small=1, k_large=4, repeats=1)
    assert np.isfinite(ms)


def test_view_server_serves_frames(tmp_path, rng):
    """Interactive viewer (tools/view.py): page, state, and an on-demand
    PNG frame through the tiled pipeline (reference --view analog,
    main.mm:231-297)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from gaussiansplatting.io import ply as ply_mod
    from gaussiansplatting.tools import view as view_mod

    cloud = ply_mod.cloud_from_params(_params(rng, n=40))
    ply_path = str(tmp_path / "model.ply")
    ply_mod.export_gaussian_ply(ply_path, cloud)

    state = view_mod.build_state(
        ply_path, width=64, height=48, fov=60.0, sh_degree=0,
        pair_capacity=2048,
    )
    srv = ThreadingHTTPServer(("127.0.0.1", 0), view_mod.make_handler(state))
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=30
        ).read()
        assert b"viewer" in page
        st = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/state", timeout=30
        ).read())
        assert st["r"] > 0
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame?az=0.5&el=0.2", timeout=120
        ).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert len(png) > 500
    finally:
        srv.shutdown()


@pytest.mark.slow
def test_view_server_interactive_training(tiny_scene_dir):
    """Viewer with a COLMAP dataset attached: /train runs real train steps
    (the reference's train-while-displaying loop, mtl_engine.mm:98-155),
    the loss is finite, the iteration advances, and the next frame renders
    from the UPDATED parameters."""
    import argparse
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from gaussiansplatting.tools import view as view_mod

    args = argparse.Namespace(
        colmap=str(tiny_scene_dir / "sparse"),
        images=str(tiny_scene_dir / "images"),
        checkpoint=None, downscale=1, iters=100,
        width=64, height=48, fov=60.0, sh_degree=0, pair_capacity=2048,
    )
    state = view_mod.build_training_state(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), view_mod.make_handler(state))
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        st = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/state", timeout=30
        ).read())
        assert st["trainable"] is True
        r = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/train?n=3", timeout=300
        ).read())
        assert r["iteration"] == 3
        assert np.isfinite(r["loss"])
        assert r["num_gaussians"] > 0
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame?az=0.3&el=0.2", timeout=120
        ).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        # params actually advanced
        assert state.iteration == 3
        assert int(state.tstate.opt.t) == 3
    finally:
        srv.shutdown()


@pytest.mark.slow
def test_train_cli_round3_flags(tiny_scene_dir, tmp_path):
    """--overflow-drop impact / --scan-steps plumb through the CLI into a
    working run."""
    from gaussiansplatting.tools import train as train_cli
    from gaussiansplatting.io import ply as ply_mod

    out_ply = str(tmp_path / "out3.ply")
    cfg_path = str(tmp_path / "cfg3.json")
    cfg = Config(
        raster=RasterConfig(pair_capacity=2048, pair_block=16),
        train=TrainConfig(epochs=2, log_interval=100),
    )
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    rc = train_cli.main([
        "--colmap", str(tiny_scene_dir / "sparse"),
        "--images", str(tiny_scene_dir / "images"),
        "--output", out_ply,
        "--config", cfg_path,
        "--capacity", "64",
        "--pair-capacity", "2048",
        "--overflow-drop", "impact",
        "--scan-steps", "2",
    ])
    assert rc == 0
    cloud = ply_mod.load_gaussian_ply(out_ply)
    assert np.isfinite(cloud.means).all()
