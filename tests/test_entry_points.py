"""Entry-point plumbing: the speed-of-light model and its peak table, the
persistent compile cache, and chip_smoke.py's refusal to run off the GPU."""

import os
import subprocess
import sys

import pytest

from gaussiansplatting.utils import sol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def test_sol_model_sanity():
    """Speed-of-light model invariants: floors scale with capacity, the
    chunk slack only trims bytes, and the floor is the larger bound."""
    base = sol.step_model(100_000, 1 << 21, 608, 800, H100)
    big = sol.step_model(1_500_000, 1 << 24, 608, 800, H100)
    assert big["bytes_total"] > 4 * base["bytes_total"]
    assert big["f32_flops"] > 4 * base["f32_flops"]
    slim = sol.step_model(1_500_000, 1 << 24, 608, 800, H100, chunk_slack=0.5)
    assert slim["bytes_total"] < big["bytes_total"]
    assert slim["f32_flops"] == big["f32_flops"]
    for m in (base, big, slim):
        assert m["floor_ms"] == max(m["t_bytes_ms"], m["t_flops_ms"])
        assert m["floor_ms"] > 0


def test_peak_table_knows_h100():
    p = sol.peaks(H100)
    assert p["hbm_gbps"] == 3350.0 and p["f32_tflops"] == 67.0
    assert "data sheet" in p["source"]


def test_peak_table_rejects_unknown_device():
    with pytest.raises(KeyError, match="no peak rates"):
        sol.peaks("cpu")
    with pytest.raises(KeyError):
        sol.step_model(1000, 1 << 12, 64, 64, "NVIDIA A100-SXM4-80GB")


def _run(code, env_updates, drop=()):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    for k in drop:
        env.pop(k, None)
    env.update(env_updates)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


_CACHE_PROBE = (
    "import jax\n"
    "from gaussiansplatting.utils.compile_cache import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_compile_cache_honours_env(tmp_path):
    got, cfg = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert got == str(tmp_path) and cfg == str(tmp_path)


def test_compile_cache_defaults_to_fixed_checkout_path():
    got, cfg = _run(_CACHE_PROBE, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == cfg == os.path.join(REPO, ".jax_cache")
    # importing the package alone sets nothing
    (cfg0,) = _run(
        "import jax, gaussiansplatting\n"
        "print(jax.config.jax_compilation_cache_dir)\n",
        {}, drop=("JAX_COMPILATION_CACHE_DIR",),
    )
    assert cfg0 == "None"


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stdout + out.stderr
