"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md §4 item 6):
tile-sharded render matches single-chip, sharded gradients match single-chip
gradients, sharded train step runs end to end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplatting.config import Config, RasterConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.ops.rasterize import render
from gaussiansplatting.parallel import mesh as mesh_mod
from gaussiansplatting.parallel.sharded import (
    make_sharded_render, make_sharded_train_step,
)
from gaussiansplatting.train import state as train_state
from gaussiansplatting.train import trainer

from conftest import make_camera_for_scene, make_scene


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs the virtual multi-device mesh"
)


def _cfg():
    return Config(raster=RasterConfig(pair_capacity=2048, pair_block=16))


def _params(rng, n=48):
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return G.from_arrays(means, log_scales, quats, raw_op, sh)


@pytest.mark.slow
def test_strip_render_matches_full(rng):
    """Rendering tile-row strips and stacking them reproduces the full image
    (single device, exercising the tile_rows path)."""
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=64)  # 4 tile rows
    params = _params(rng)
    full, _ = jax.jit(render, static_argnums=2)(params, cam, cfg.raster)

    strips = []
    for row0 in range(0, 4, 2):
        s, _ = jax.jit(
            lambda p, c, r: render(p, c, cfg.raster, tile_rows=(r, 2))
        )(params, cam, jnp.int32(row0))
        strips.append(np.asarray(s))
    stacked = np.concatenate(strips, axis=0)[: cam.height]
    np.testing.assert_allclose(stacked, np.asarray(full), atol=1e-5)


def test_sharded_render_matches_single(rng):
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=64)
    params = _params(rng)
    full, _ = jax.jit(render, static_argnums=2)(params, cam, cfg.raster)

    m = mesh_mod.make_mesh()
    srender = make_sharded_render(m, cfg)
    out = srender(params, cam)
    np.testing.assert_allclose(np.asarray(out.image), np.asarray(full), atol=1e-5)


def test_sharded_step_matches_single_chip(rng):
    """One sharded step == one single-chip step (same grads via psum)."""
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=64)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    start_params = _params(np.random.default_rng(99))
    st_single = train_state.create(start_params)
    st_shard = train_state.create(start_params)

    st_single, m_single = trainer.train_step(st_single, cam, gt, cfg, 100)

    m = mesh_mod.make_mesh()
    sstep = make_sharded_train_step(m, cfg, 100)
    st_shard, m_shard = sstep(st_shard, cam, gt)

    np.testing.assert_allclose(float(m_shard.loss), float(m_single.loss), rtol=1e-5)
    assert int(m_shard.num_pairs) == int(m_single.num_pairs)
    np.testing.assert_allclose(
        np.asarray(st_shard.params.means),
        np.asarray(st_single.params.means),
        atol=2e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st_shard.params.raw_opacities),
        np.asarray(st_single.params.raw_opacities),
        atol=2e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st_shard.accum.grad_accum),
        np.asarray(st_single.accum.grad_accum),
        atol=1e-4,
    )


@pytest.mark.slow
def test_sharded_multi_step_training(rng):
    """A few sharded steps reduce the loss."""
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=48)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st = train_state.create(_params(np.random.default_rng(5)))
    m = mesh_mod.make_mesh()
    sstep = make_sharded_train_step(m, cfg, 1000)
    losses = []
    for _ in range(8):
        st, metrics = sstep(st, cam, gt)
        losses.append(float(metrics.loss))
    assert losses[-1] < losses[0]


@pytest.mark.slow
def test_sharded_loop_with_densify(rng):
    """train_loop with mesh_devices>1 runs the densify/reset schedule on the
    sharded step (the multi-chip CLI path, tools/train.py --devices N)."""
    from gaussiansplatting.config import DensityConfig

    cfg = _cfg().replace(
        density=DensityConfig(
            densify_from_iter=1, densify_until_iter=50, densify_interval=3,
            opacity_reset_interval=8, grad_threshold=1e-9,
        ),
    )
    cam = make_camera_for_scene(width=64, height=48)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    means, log_scales, quats, raw_op, sh_dc = make_scene(
        np.random.default_rng(11), n=24, spread=0.6
    )
    sh = np.zeros((24, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    start = G.from_arrays(means, log_scales, quats, raw_op, sh, capacity=96)

    st = train_state.create(start)
    st = trainer.train_loop(
        st, [cam], [gt], cfg, scene_extent=1.0, num_epochs=10,
        mesh_devices=min(4, len(jax.devices())),
    )
    assert int(st.opt.t) == 10
    # densification with grad_threshold ~0 must have grown the population
    assert int(np.asarray(st.params.alive).sum()) > 24
    assert np.isfinite(np.asarray(st.params.means)).all()


def test_sharded_step_with_pallas_blend(rng, blend_interpret):
    """The Pallas custom-VJP blend traces through shard_map (interpret mode
    here; chip_smoke.py --devices 4 runs the same path compiled on four
    GPUs) and matches the XLA blend under the same sharding."""
    cfg = Config(raster=RasterConfig(
        pair_capacity=2048, pair_block=16, blend_impl="auto"
    ))
    cam = make_camera_for_scene(width=64, height=64)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    st = train_state.create(_params(np.random.default_rng(5)))
    m = mesh_mod.make_mesh()
    sstep = make_sharded_train_step(m, cfg, 100)
    st, metrics = sstep(st, cam, gt)
    assert blend_interpret                     # the kernel ran in the strips
    assert np.isfinite(float(metrics.loss))

    # and it matches the XLA blend under the same sharding
    cfg_x = Config(
        raster=RasterConfig(pair_capacity=2048, pair_block=16, blend_impl="xla")
    )
    st_x = train_state.create(_params(np.random.default_rng(5)))
    sstep_x = make_sharded_train_step(m, cfg_x, 100)
    st_x, metrics_x = sstep_x(st_x, cam, gt)
    np.testing.assert_allclose(
        float(metrics.loss), float(metrics_x.loss), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.params.means), np.asarray(st_x.params.means), atol=2e-5
    )


@pytest.mark.slow
def test_batched_sharded_step_matches_single_chip_batched(rng):
    """batch_views composed with mesh_devices (the round-2
    NotImplementedError): one sharded K=2 accumulation step equals the
    single-chip train_step_batched — parameters, Adam state, and density
    accumulators."""
    from gaussiansplatting.parallel.sharded import (
        make_sharded_train_step_batched,
    )

    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=64)
    gt_params = _params(rng)
    gt1, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)
    gt2 = jnp.clip(gt1 * 0.8 + 0.1, 0.0, 1.0)

    cams_k = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), cam, cam)
    gts_k = jnp.stack([gt1, gt2])

    start = _params(np.random.default_rng(99))
    st_single = train_state.create(start)
    st_shard = train_state.create(start)

    st_single, m_single = trainer.train_step_batched(
        st_single, cams_k, gts_k, cfg, 100
    )
    m = mesh_mod.make_mesh()
    sstep = make_sharded_train_step_batched(m, cfg, 100, 2)
    st_shard, m_shard = sstep(st_shard, cams_k, gts_k)

    np.testing.assert_allclose(
        float(m_single.loss), float(m_shard.loss), rtol=1e-5
    )
    assert int(m_single.num_pairs) == int(m_shard.num_pairs)
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_single.params, f)),
            np.asarray(getattr(st_shard.params, f)),
            atol=1e-5, err_msg=f,
        )
    np.testing.assert_allclose(
        np.asarray(st_single.accum.grad_accum),
        np.asarray(st_shard.accum.grad_accum), atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(st_single.accum.grad_count),
        np.asarray(st_shard.accum.grad_count),
    )


def test_chunked_psum_step_bit_equal(rng):
    """The overlapped gradient all-reduce (grad_psum_chunks>1, SURVEY.md
    §7.5.6: chunked per-parameter-group psums that can start before the
    backward finishes) is BIT-identical to the single-psum step — psum is
    elementwise, so slicing the Gaussian axis cannot change any value."""
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=64)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    start = _params(np.random.default_rng(99))
    m = mesh_mod.make_mesh()

    st_plain, _ = make_sharded_train_step(m, cfg, 100)(
        train_state.create(start), cam, gt
    )
    st_chunk, m_chunk = make_sharded_train_step(m, cfg, 100, grad_psum_chunks=4)(
        train_state.create(start), cam, gt
    )
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st_plain.params, f)),
            np.asarray(getattr(st_chunk.params, f)), err_msg=f,
        )
    np.testing.assert_array_equal(
        np.asarray(st_plain.accum.grad_accum),
        np.asarray(st_chunk.accum.grad_accum),
    )
    assert np.isfinite(float(m_chunk.loss))


@pytest.mark.slow
def test_chunked_psum_batched_step_bit_equal(rng):
    """The batched (K-view) sharded step takes the same grad_psum_chunks
    knob with the same bit-equality guarantee."""
    cfg = _cfg()
    cam = make_camera_for_scene(width=64, height=64)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)
    start = _params(np.random.default_rng(99))
    m = mesh_mod.make_mesh()

    cams_k = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), cam, cam)
    gts_k = jnp.stack([gt, jnp.clip(gt * 0.8 + 0.1, 0.0, 1.0)])
    from gaussiansplatting.parallel.sharded import (
        make_sharded_train_step_batched,
    )

    stb_plain, _ = make_sharded_train_step_batched(m, cfg, 100, 2)(
        train_state.create(start), cams_k, gts_k
    )
    stb_chunk, _ = make_sharded_train_step_batched(
        m, cfg, 100, 2, grad_psum_chunks=3
    )(train_state.create(start), cams_k, gts_k)
    np.testing.assert_array_equal(
        np.asarray(stb_plain.params.means), np.asarray(stb_chunk.params.means)
    )


@pytest.mark.slow
def test_batched_sharded_loop_with_densify(rng):
    """train_loop with batch_views>1 AND mesh_devices>1 runs the densify /
    reset schedule end to end (the previously unsupported composition)."""
    from gaussiansplatting.config import DensityConfig

    cfg = _cfg().replace(
        density=DensityConfig(
            densify_from_iter=1, densify_until_iter=50, densify_interval=3,
            opacity_reset_interval=8, grad_threshold=1e-9,
        ),
    )
    cam = make_camera_for_scene(width=64, height=48)
    gt_params = _params(rng)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    means, log_scales, quats, raw_op, sh_dc = make_scene(
        np.random.default_rng(11), n=24, spread=0.6
    )
    sh = np.zeros((24, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    start = G.from_arrays(means, log_scales, quats, raw_op, sh, capacity=96)

    st = train_state.create(start)
    st = trainer.train_loop(
        st, [cam, cam], [gt, gt], cfg, scene_extent=1.0, num_epochs=8,
        mesh_devices=min(2, len(jax.devices())), batch_views=2,
    )
    assert int(st.opt.t) == 8
    assert int(np.asarray(st.params.alive).sum()) > 24
    assert np.isfinite(np.asarray(st.params.means)).all()


@pytest.mark.slow
def test_sharded_pallas_step_at_scale(rng, blend_interpret):
    """Sharding x Pallas-blend composition one notch up: 512 Gaussians,
    256x256 image, 8 tile strips, every strip running the blend kernels
    (interpret mode on CPU) inside shard_map.  The sharded step must
    reproduce the single-device step, and the sharded render the
    full-frame render."""
    cfg = Config(raster=RasterConfig(
        pair_capacity=1 << 14, pair_block=16, blend_impl="auto",
    ))
    cam = make_camera_for_scene(width=256, height=256)  # 16 tile rows
    gt_params = _params(rng, n=512)
    gt, _ = jax.jit(render, static_argnums=2)(gt_params, cam, cfg.raster)

    m = mesh_mod.make_mesh()
    assert m.devices.size == 8

    # render equivalence
    srender = make_sharded_render(m, cfg)
    out = srender(gt_params, cam)
    # strips chunk tile runs at different block boundaries than the full
    # frame, reassociating the (C,T) composition: fp32 noise, not error
    np.testing.assert_allclose(
        np.asarray(out.image), np.asarray(gt), atol=1e-4
    )

    # one-step training equivalence (params after Adam, loss, pair count)
    start = _params(np.random.default_rng(99), n=512)
    st_single, m_single = trainer.train_step(
        train_state.create(start), cam, gt, cfg, 100
    )
    st_shard, m_shard = make_sharded_train_step(m, cfg, 100)(
        train_state.create(start), cam, gt
    )
    np.testing.assert_allclose(
        float(m_shard.loss), float(m_single.loss), rtol=1e-5
    )
    assert int(m_shard.num_pairs) == int(m_single.num_pairs)
    assert int(m_single.num_pairs) > 0
    # densification accumulator (pre-Adam gradient signal): tight
    np.testing.assert_allclose(
        np.asarray(st_shard.accum.grad_accum),
        np.asarray(st_single.accum.grad_accum), atol=1e-4,
    )
    # post-Adam params: strips chunk tile runs at different block
    # boundaries, so fp32-noise gradient differences exist, and FIRST-step
    # Adam normalizes ANY nonzero gradient to a full +/-lr move
    # (update ~ lr*sign(g) at t=1) — a noise-level sign flip costs 2*lr.
    # The meaningful equivalences are the tight loss/pairs/image/accum
    # checks above; for params the honest bound is the update envelope.
    tcfg = cfg.optim
    lr = {"means": tcfg.position_lr_init, "log_scales": tcfg.scale_lr,
          "quats": tcfg.rotation_lr, "raw_opacities": tcfg.opacity_lr,
          "sh": tcfg.sh_lr}
    for f, lr_f in lr.items():
        a = np.asarray(getattr(st_shard.params, f))
        b = np.asarray(getattr(st_single.params, f))
        d = np.abs(a - b)
        assert d.max() <= 3.0 * lr_f, f"{f}: {d.max()} > 3 lr"
