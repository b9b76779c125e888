"""parallel/launch.py tests (SURVEY.md §2.3 multi-host row; VERDICT r4
weak #5: launch.py was the only untested component).

The fast test covers the single-process no-op contract.  The slow tests
spawn REAL second processes: `jax.distributed.initialize` over a loopback
coordinator, a cross-process global-mesh reduction, and a few steps of
`tools/train --coordinator` with one CPU device per process — the same
process topology as several accelerator hosts, over loopback.

Subprocesses get PYTHONPATH set to the repo only and JAX_PLATFORMS=cpu, so
they exercise plain multi-process CPU whatever the parent environment.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

from conftest import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_single_process_noop():
    """No coordinator/env => no jax.distributed, just a topology summary of
    the already-initialized backend (the virtual 8-device CPU mesh)."""
    from gaussiansplatting.parallel import launch

    topo = launch.initialize()
    assert topo["process_index"] == 0
    assert topo["process_count"] == 1
    assert topo["global_devices"] == len(jax.devices())
    assert launch.is_primary()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _subproc_env() -> dict:
    """CPU-only env: one CPU device per process, repo on path.  PYTHONPATH
    is deliberately NOT inherited (see module docstring)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ""  # exactly one CPU device per process
    env.pop("PYTHONSTARTUP", None)
    return env


def _run_pair(script: str, args_fn, timeout=420):
    """Run `script` as process 0 and 1 concurrently; return both results."""
    procs = [
        subprocess.Popen(
            [sys.executable, script] + [str(a) for a in args_fn(pid)],
            env=_subproc_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    return outs


_COLLECTIVE_RUNNER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
pid, port = int(sys.argv[1]), sys.argv[2]
from gaussiansplatting.parallel import launch
topo = launch.initialize(
    coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert topo == {"process_index": pid, "process_count": 2,
                "local_devices": 1, "global_devices": 2}, topo
assert launch.is_primary() == (pid == 0)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
mesh = Mesh(np.array(jax.devices()), ("d",))
local = jnp.full((2, 4), float(pid + 1))
x = jax.make_array_from_single_device_arrays(
    (4, 4), NamedSharding(mesh, P("d")), [local])
s = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(x)
print("RESULT", pid, float(s), flush=True)
"""


@pytest.mark.slow
def test_two_process_initialize_and_reduce(tmp_path):
    """jax.distributed over loopback: both processes see the 2-device
    global topology and agree on a cross-process reduction."""
    script = tmp_path / "runner.py"
    script.write_text(_COLLECTIVE_RUNNER)
    port = _free_port()
    outs = _run_pair(str(script), lambda pid: [pid, port])
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{out}"
        # sum over the global array: 8 * 1.0 + 8 * 2.0 = 24
        assert f"RESULT {pid} 24.0" in out, out


_TRAIN_RUNNER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
pid, port, scene, outdir = sys.argv[1:5]
import os
os.environ["NUM_PROCESSES"] = "2"
os.environ["PROCESS_ID"] = pid
from gaussiansplatting.tools import train as train_cli
rc = train_cli.main([
    "--colmap", scene + "/sparse",
    "--images", scene + "/images",
    "--output", outdir + "/out.ply",
    "--config", scene + "/cfg.json",
    "--capacity", "64",
    "--pair-capacity", "2048",
    "--epochs", "1",
    "--devices", "2",
    "--coordinator", "127.0.0.1:" + port,
    "--metrics", outdir + "/metrics.jsonl",
])
print("TRAIN_RC", pid, rc, flush=True)
"""


@pytest.fixture
def tiny_scene(tmp_path, rng):
    """2-view COLMAP scene with rendered GT images (mirrors
    test_tools.tiny_scene_dir, local copy so this file stays standalone)."""
    import jax.numpy as jnp  # noqa: F401  (jax initialized by conftest)

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.core import camera as camera_mod
    from gaussiansplatting.core import gaussians as G
    from gaussiansplatting.io import images as images_mod
    from gaussiansplatting.ops.rasterize import render
    from test_io import write_cameras_bin, write_images_bin, write_points_bin

    sparse = tmp_path / "sparse"
    images = tmp_path / "images"
    sparse.mkdir()
    images.mkdir()
    w = h = 64
    fx = fy = 76.8
    cfg = Config(raster=RasterConfig(pair_capacity=2048, pair_block=16))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    write_cameras_bin(
        str(sparse / "cameras.bin"), [(1, 1, w, h, [fx, fy, w / 2, h / 2])]
    )
    q = [1.0, 0.0, 0.0, 0.0]
    write_images_bin(
        str(sparse / "images.bin"),
        [(1, q, [0.0, 0.0, 0.0], 1, "v0.png", 0),
         (2, q, [0.15, 0.0, 0.0], 1, "v1.png", 0)],
    )
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=40, spread=0.6)
    pts = [
        (i, list(map(float, p)), [128, 128, 128], 0.5, 0)
        for i, p in enumerate(means)
    ]
    write_points_bin(str(sparse / "points3D.bin"), pts)
    sh = np.zeros((40, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    gt_params = G.from_arrays(means, log_scales, quats, raw_op, sh)
    for name, tx in (("v0.png", 0.0), ("v1.png", 0.15)):
        cam = camera_mod.make_camera(q, [tx, 0, 0], fx, fy, w / 2, h / 2, w, h)
        img, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)
        images_mod.save_png(str(images / name), np.asarray(img))
    return tmp_path


@pytest.mark.slow
def test_two_process_train_cli(tiny_scene, tmp_path):
    """tools/train --coordinator: a few real steps with the tile-sharded
    step over a 2-process global mesh; only the primary writes files."""
    out0 = tmp_path / "p0"
    out1 = tmp_path / "p1"
    out0.mkdir()
    out1.mkdir()
    script = tmp_path / "runner.py"
    script.write_text(_TRAIN_RUNNER)
    port = _free_port()
    outs = _run_pair(
        str(script),
        lambda pid: [pid, port, tiny_scene, out0 if pid == 0 else out1],
        timeout=540,
    )
    for pid, (rc, out) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{out}"
        assert f"TRAIN_RC {pid} 0" in out, out

    # the primary trained and wrote everything ...
    lines = [json.loads(l) for l in open(out0 / "metrics.jsonl")]
    events = {l["event"] for l in lines}
    assert {"start", "scene", "step", "export_ply"} <= events
    start = next(l for l in lines if l["event"] == "start")
    assert start["process_count"] == 2
    assert start["global_devices"] == 2
    steps = [l for l in lines if l["event"] == "step"]
    assert len(steps) == 2  # 1 epoch x 2 views
    assert all(np.isfinite(s["loss"]) for s in steps)
    assert (out0 / "out.ply").exists()

    # ... and the secondary wrote nothing (write-once discipline)
    assert not (out1 / "metrics.jsonl").exists()
    assert not (out1 / "out.ply").exists()
