"""Test harness: run everything on a virtual 8-device CPU mesh so sharding
logic is exercised without accelerator hardware (SURVEY.md §4).

JAX_PLATFORMS defaults to cpu here.  Tests marked ``gpu`` need the card:
they skip unless JAX's default backend is the GPU, decided per test at run
time (never at import, so every test worker collects the same tests).  On
the card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

# Must happen before jax initializes a backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (heavy end-to-end/integration)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy end-to-end/integration test — skipped by default, run "
        "with --runslow (full suite) or -m slow (slow tests only)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: runs compiled GPU kernels — skipped unless JAX's default "
        "backend is the GPU (JAX_PLATFORMS=cuda python -m pytest -m gpu)",
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip(
            f"needs the GPU (default backend is {jax.default_backend()}); "
            "run with JAX_PLATFORMS=cuda python -m pytest -m gpu on the card"
        )


def pytest_collection_modifyitems(config, items):
    # Fast default suite (~8 min); `--runslow` restores the full ~40 min
    # suite.  An explicit -m expression also disables the skip so
    # `-m slow` works as expected.
    if config.getoption("--runslow") or config.getoption("markexpr"):
        return
    skip_slow = pytest.mark.skip(reason="slow: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def blend_interpret(monkeypatch):
    """Routes blend_impl="auto" to the Pallas-Triton blend in the Pallas
    interpreter (the kernels have no CPU lowering); "xla" keeps the scan.
    Compiled functions are dropped on entry and exit, so no trace of the
    other blend is reused under the same config.  Yields the list of the
    kernel's traced [NB, B] shapes."""
    from gaussiansplatting.ops import pallas_blend, rasterize

    kernel = pallas_blend.block_blend_cols
    traced = []

    def interpreted(*cols_and_consts):
        traced.append(cols_and_consts[0].shape)
        return kernel(*cols_and_consts, True)

    monkeypatch.setattr(rasterize, "_use_kernel", lambda impl: impl == "auto")
    monkeypatch.setattr(pallas_blend, "block_blend_cols", interpreted)
    jax.clear_caches()
    yield traced
    jax.clear_caches()


@pytest.fixture
def rng():
    # Function-scoped: every test sees the same deterministic stream, so
    # results don't depend on which tests ran before (FD-based gradient
    # tolerances are scene-sensitive in fp32).
    return np.random.default_rng(1234)


def make_scene(rng, n=64, spread=1.0, z_center=4.0, opacity_lo=-1.0, opacity_hi=3.0):
    """Random synthetic scene in front of a canonical camera at the origin
    looking down +z (COLMAP convention)."""
    means = np.concatenate(
        [
            rng.uniform(-spread, spread, (n, 2)),
            rng.uniform(z_center - 1.0, z_center + 1.0, (n, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    log_scales = rng.uniform(-3.2, -1.8, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    raw_op = rng.uniform(opacity_lo, opacity_hi, (n,)).astype(np.float32)
    sh_dc = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return means, log_scales, quats, raw_op, sh_dc


@pytest.fixture
def small_scene(rng):
    return make_scene(rng, n=64)


def make_camera_for_scene(width=64, height=48, fov_scale=1.2):
    """Identity-pose camera with intrinsics that frame the unit box at z≈4."""
    from gaussiansplatting.core.camera import make_camera

    fx = width * fov_scale
    fy = width * fov_scale
    return make_camera(
        quat_wxyz=np.array([1.0, 0.0, 0.0, 0.0], np.float32),
        translation=np.zeros(3, np.float32),
        fx=fx,
        fy=fy,
        cx=width / 2,
        cy=height / 2,
        cam_width=width,
        cam_height=height,
    )
