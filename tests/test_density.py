"""Density control: prune / clone / split decisions, interleaved compaction,
Adam-state carrying, capacity clamping (reference: density_control.mm)."""

import numpy as np
import jax
import jax.numpy as jnp

from gaussiansplatting.config import DensityConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.density import control
from gaussiansplatting.train import optimizer


def _mk(rng, n=8, capacity=32, log_scale=-3.0, raw_op=2.0):
    params = G.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32),
        np.full((n, 3), log_scale, np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        np.full((n,), raw_op, np.float32),
        rng.normal(size=(n, 4, 3)).astype(np.float32),
        capacity=capacity,
    )
    opt = optimizer.init_state(params)
    accum = control.init_accum(capacity)
    return params, opt, accum


CFG = DensityConfig()
KEY = jax.random.PRNGKey(0)
EXTENT = 10.0


def _apply(params, opt, accum, iteration):
    return control.apply(
        params, opt, accum, jnp.int32(iteration), KEY,
        EXTENT, jnp.float32(100.0), jnp.float32(2.0 * EXTENT), CFG,
    )


def test_noop_when_nothing_triggers(rng):
    params, opt, accum, = _mk(rng)
    new_params, new_opt, _, stats = _apply(params, opt, accum, 1000)
    assert int(stats.pruned) == int(stats.cloned) == int(stats.split) == 0
    assert int(stats.count) == 8
    np.testing.assert_allclose(
        np.asarray(new_params.means[:8]), np.asarray(params.means[:8])
    )
    assert bool(jnp.all(new_params.alive[:8])) and not bool(jnp.any(new_params.alive[8:]))


def test_prune_low_opacity(rng):
    params, opt, accum = _mk(rng)
    # sigmoid(-6) = 0.0025 < 0.005 threshold
    params = params.replace(
        raw_opacities=params.raw_opacities.at[2].set(-6.0).at[5].set(-6.0)
    )
    new_params, _, _, stats = _apply(params, opt, accum, 1000)
    assert int(stats.pruned) == 2
    assert int(stats.count) == 6
    # survivors keep their values, in order, compacted
    old = np.asarray(params.means[:8])
    expected = np.concatenate([old[:2], old[3:5], old[6:8]])
    np.testing.assert_allclose(np.asarray(new_params.means[:6]), expected)


def test_clone_small_high_grad(rng):
    params, opt, accum = _mk(rng, log_scale=-4.0)  # tiny -> clone
    # mark gaussian 3 as high-gradient
    accum = accum.replace(
        grad_accum=accum.grad_accum.at[3].set(1.0),
        grad_count=accum.grad_count.at[3].set(1),
    )
    # give it distinguishable optimizer state to verify carrying
    opt = opt.replace(m={**opt.m, "means": opt.m["means"].at[3].set(7.0)})
    new_params, new_opt, new_accum, stats = _apply(params, opt, accum, 1000)
    assert int(stats.cloned) == 1 and int(stats.split) == 0
    assert int(stats.count) == 9
    # clone is an identical copy right after the original (interleaved order)
    np.testing.assert_allclose(
        np.asarray(new_params.means[3]), np.asarray(new_params.means[4])
    )
    np.testing.assert_allclose(
        np.asarray(new_params.means[3]), np.asarray(params.means[3])
    )
    # original keeps momentum, copy starts at zero
    np.testing.assert_allclose(np.asarray(new_opt.m["means"][3]), 7.0)
    np.testing.assert_allclose(np.asarray(new_opt.m["means"][4]), 0.0)
    # accumulators reset
    np.testing.assert_allclose(np.asarray(new_accum.grad_accum), 0.0)


def test_split_large_high_grad(rng):
    params, opt, accum = _mk(rng, log_scale=0.0)  # exp(0)=1 > 0.01*extent
    accum = accum.replace(
        grad_accum=accum.grad_accum.at[1].set(1.0),
        grad_count=accum.grad_count.at[1].set(1),
    )
    opt = opt.replace(m={**opt.m, "means": opt.m["means"].at[1].set(7.0)})
    new_params, new_opt, _, stats = _apply(params, opt, accum, 1000)
    assert int(stats.split) == 1 and int(stats.cloned) == 0
    assert int(stats.count) == 9
    # children at +/- offset around parent, scales /1.6 in log space
    c1 = np.asarray(new_params.means[1])
    c2 = np.asarray(new_params.means[2])
    parent = np.asarray(params.means[1])
    np.testing.assert_allclose((c1 + c2) / 2, parent, atol=1e-5)
    assert np.linalg.norm(c1 - parent) > 1e-4
    np.testing.assert_allclose(
        np.asarray(new_params.log_scales[1]),
        np.asarray(params.log_scales[1]) + np.log(1 / 1.6),
        rtol=1e-4,
    )
    # both children get fresh optimizer state
    np.testing.assert_allclose(np.asarray(new_opt.m["means"][1]), 0.0)
    np.testing.assert_allclose(np.asarray(new_opt.m["means"][2]), 0.0)


def test_no_densify_outside_window(rng):
    params, opt, accum = _mk(rng, log_scale=-4.0)
    accum = accum.replace(
        grad_accum=accum.grad_accum + 1.0,
        grad_count=accum.grad_count + 1,
    )
    for it in [400, 15000]:  # before from_iter (>500 strictly), at until_iter
        _, _, _, stats = _apply(params, opt, accum, it)
        assert int(stats.cloned) == 0 and int(stats.split) == 0, it


def test_world_scale_prune_after_first_reset(rng):
    params, opt, accum = _mk(rng, log_scale=0.5)  # exp(0.5)=1.65 > 0.1*10
    _, _, _, s_before = _apply(params, opt, accum, 2999)
    _, _, _, s_after = _apply(params, opt, accum, 3001)
    assert int(s_before.pruned) == 0      # screen pruning needs iter > 3000
    assert int(s_after.pruned) == 8


def test_capacity_clamp_drops_clones_first(rng):
    params, opt, accum = _mk(rng, n=8, capacity=10, log_scale=-4.0)
    accum = accum.replace(
        grad_accum=accum.grad_accum.at[:8].set(1.0),
        grad_count=accum.grad_count.at[:8].set(1),
    )
    new_params, _, _, stats = _apply(params, opt, accum, 1000)
    # 8 alive, 8 want clones -> would be 16 > capacity 10 -> keep 2 clones
    assert int(stats.cloned) == 2
    assert int(stats.count) == 10
    assert int(new_params.count()) == 10


def test_apply_is_jittable(rng):
    params, opt, accum = _mk(rng)
    jitted = jax.jit(control.apply, static_argnames=("cfg",))
    out = jitted(
        params, opt, accum, jnp.int32(1000), KEY, EXTENT,
        jnp.float32(100.0), jnp.float32(20.0), CFG,
    )
    assert int(out[3].count) == 8


def test_densify_at_real_scale_hits_hard_cap(rng):
    """Stress the 1.5M hard-cap clone-drop path and the interleaved scatter
    rebuild at real population sizes (1.4M alive, 1.6M capacity) — the sizes
    config #4 training reaches (mtl_engine.mm:1047-1221), which the toy-
    capacity tests above never exercise.

    Layout: [0,100k) pruned, [100k,150k) split, [150k,450k) clone requests,
    rest keep.  Raw new count 1.65M exceeds the 1.5M cap by 150k, so the
    150k lowest-index clone REQUESTS are dropped (density_control.mm:358-382)
    — those Gaussians survive as plain keeps — leaving exactly 1.5M.
    """
    C = 1_600_000
    n = 1_400_000
    p0, s0, s1, c0, c1 = 0, 100_000, 150_000, 150_000, 450_000

    means = rng.normal(size=(n, 3)).astype(np.float32)
    log_scales = np.full((n, 3), -4.0, np.float32)
    log_scales[s0:s1] = np.log(0.5)  # > percent_dense*extent -> split
    raw_op = np.full((n,), 2.0, np.float32)
    raw_op[p0:s0] = -6.0             # sigmoid(-6) < 0.005 -> prune
    params = G.from_arrays(
        means, log_scales,
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        raw_op, np.zeros((n, 4, 3), np.float32), capacity=C,
    )
    opt = optimizer.init_state(params)
    sentinel_clone, sentinel_split = c1 - 1_000, s0  # surviving clone / a split
    opt = opt.replace(m={**opt.m, "means": opt.m["means"]
                         .at[sentinel_clone].set(7.0)})
    accum = control.init_accum(C)
    ga = np.zeros((C,), np.float32)
    gc = np.zeros((C,), np.int32)
    ga[s0:c1] = 1.0                  # split + clone bands over threshold
    gc[s0:c1] = 1
    accum = accum.replace(grad_accum=jnp.asarray(ga), grad_count=jnp.asarray(gc))

    new_params, new_opt, _, stats = _apply(params, opt, accum, 5000)

    assert int(stats.pruned) == 100_000
    assert int(stats.split) == 50_000
    assert int(stats.cloned) == 150_000  # 300k requested, 150k dropped
    assert int(stats.count) == 1_500_000
    alive = np.asarray(new_params.alive)
    assert alive[:1_500_000].all() and not alive[1_500_000:].any()

    m_in = np.asarray(params.means)
    m_out = np.asarray(new_params.means)
    sc_out = np.asarray(new_params.log_scales)
    # split children at the front: symmetric about the parent, shrunk scales
    np.testing.assert_allclose(
        m_out[0] + m_out[1], 2.0 * m_in[s0], rtol=0, atol=1e-5
    )
    np.testing.assert_allclose(
        sc_out[0], np.log(0.5) - np.log(1.6), rtol=0, atol=1e-5
    )
    # dropped-clone region [150k,300k): single compacted copies
    np.testing.assert_allclose(m_out[100_000], m_in[c0])
    np.testing.assert_allclose(m_out[100_000 + 77], m_in[c0 + 77])
    # surviving-clone region [300k,450k): interleaved identical pairs
    off = 250_000 + 2 * (sentinel_clone - 300_000)
    np.testing.assert_allclose(m_out[off], m_in[sentinel_clone])
    np.testing.assert_allclose(m_out[off + 1], m_in[sentinel_clone])
    # plain keeps after the densify bands
    np.testing.assert_allclose(m_out[550_000 + 5], m_in[c1 + 5])
    # Adam state rides the permutation: original keeps momentum, copy resets
    m_mom = np.asarray(new_opt.m["means"])
    np.testing.assert_allclose(m_mom[off], 7.0)
    np.testing.assert_allclose(m_mom[off + 1], 0.0)
