"""GaussianModel facade tests (reference surface: MTLEngine, mtl_engine.hpp:40-57)."""

import numpy as np
import jax.numpy as jnp

from gaussiansplatting.config import Config, RasterConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.models import GaussianModel

from conftest import make_camera_for_scene, make_scene


def _cfg():
    return Config(raster=RasterConfig(pair_capacity=2048, pair_block=16))


def _params(rng, n=48):
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return G.from_arrays(means, log_scales, quats, raw_op, sh)


def test_model_roundtrip_and_train(tmp_path, rng):
    cam = make_camera_for_scene(width=64, height=48)
    gt_model = GaussianModel.from_params(_params(rng), _cfg())
    gt = gt_model.render(cam)
    assert gt.shape == (48, 64, 3)

    model = GaussianModel.from_params(_params(np.random.default_rng(7)), _cfg())
    before = float(np.abs(model.render(cam) - gt).mean())
    model.train([cam], [jnp.asarray(gt)], epochs=6)
    after = float(np.abs(model.render(cam) - gt).mean())
    assert after < before
    assert model.num_gaussians == 48

    ply = str(tmp_path / "m.ply")
    assert model.save_ply(ply) == 48
    reloaded = GaussianModel.from_ply(ply, _cfg())
    np.testing.assert_allclose(reloaded.render(cam), model.render(cam), atol=1e-3)

    ck = str(tmp_path / "m.npz")
    model.save_checkpoint(ck)
    resumed = GaussianModel.from_checkpoint(ck)
    np.testing.assert_array_equal(
        np.asarray(resumed.params.means), np.asarray(model.params.means)
    )


def test_pytree_replace_keeps_type_and_static_fields():
    """The dataclass pytrees (core/pytree.py): .replace returns an updated
    frozen copy, leaves flatten in field order, static fields do not."""
    import dataclasses

    import jax

    cam = make_camera_for_scene(width=40, height=24)
    leaves, treedef = jax.tree_util.tree_flatten(cam)
    assert len(leaves) == 6                      # width/height are static
    cam2 = cam.replace(fx=jnp.float32(7.0))
    assert type(cam2) is type(cam) and float(cam2.fx) == 7.0
    assert float(cam.fx) != 7.0 and cam2.width == 40 and cam2.height == 24
    try:
        cam.fx = 1.0
        raise AssertionError("pytree dataclasses must be frozen")
    except dataclasses.FrozenInstanceError:
        pass
    p = G.zeros(5)
    q = p.replace(alive=p.alive.at[0].set(True))
    assert int(q.count()) == 1 and int(p.count()) == 0
    doubled = jax.tree_util.tree_map(lambda x: x * 2, q)
    assert type(doubled) is G.GaussianParams


def test_pytree_static_fields_under_jit():
    """Camera width/height are static under jit: usable as shapes, and a
    new resolution retraces instead of failing."""
    import jax

    traces = []

    @jax.jit
    def blank(cam):
        traces.append((cam.width, cam.height))
        return jnp.zeros((cam.height, cam.width)) + cam.fx

    a = blank(make_camera_for_scene(width=32, height=16))
    b = blank(make_camera_for_scene(width=32, height=16))
    c = blank(make_camera_for_scene(width=48, height=16))
    assert a.shape == b.shape == (16, 32) and c.shape == (16, 48)
    assert traces == [(32, 16), (48, 16)]
