"""Property tests for (tile, depth) pair expansion + sort + block alignment
(SURVEY.md §4 item 4: sort correctness property tests).

Reference semantics being locked in: one pair per covered tile per emitting
Gaussian (generateTilePairs, tiled_shaders.metal:745-794), pairs grouped by
tile in depth order (the CPU radix sort over (tile<<32|depth) keys,
tiled_rasterizer.mm:27-102), whole-Gaussian drop on capacity overflow
(tiled_shaders.metal:779-780)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplatting.config import RasterConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.ops import pairs as pairs_mod
from gaussiansplatting.ops import projection as proj_mod

from conftest import make_camera_for_scene, make_scene


def _setup(rng, n=64, pair_capacity=4096, block=16, width=64, height=48):
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.7)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    params = G.from_arrays(means, log_scales, quats, raw_op, sh)
    cam = make_camera_for_scene(width=width, height=height)
    cfg = RasterConfig(pair_capacity=pair_capacity, pair_block=block)
    proj = jax.jit(proj_mod.project, static_argnums=2)(params, cam, cfg)
    tiles_x = proj_mod.num_tiles(width, cfg.tile_size)
    tiles_y = proj_mod.num_tiles(height, cfg.tile_size)
    pb = jax.jit(
        lambda p: pairs_mod.build_pairs(p, tiles_x, tiles_y, pair_capacity, block)
    )(proj)
    return params, cam, cfg, proj, pb, tiles_x, tiles_y


def _brute_force_pairs(proj, tiles_x, tiles_y):
    """(tile, depth, gid) triples straight from the projection rects."""
    out = []
    n = proj.depth.shape[0]
    tmin = np.asarray(proj.tile_min)
    tmax = np.asarray(proj.tile_max)
    ntl = np.asarray(proj.n_tiles)
    depth = np.asarray(proj.depth)
    for g in range(n):
        if ntl[g] <= 0:
            continue
        for ty in range(tmin[g, 1], tmax[g, 1] + 1):
            for tx in range(tmin[g, 0], tmax[g, 0] + 1):
                out.append((ty * tiles_x + tx, depth[g], g))
    return out


def test_pair_multiset_matches_brute_force(rng):
    _, _, _, proj, pb, tiles_x, tiles_y = _setup(rng)
    expect = _brute_force_pairs(proj, tiles_x, tiles_y)
    assert int(pb.num_pairs) == len(expect)
    assert not bool(pb.overflow)

    got = []
    gid = np.asarray(pb.gaussian_id)
    block_tile = np.asarray(pb.block_tile)
    block = gid.shape[0] // block_tile.shape[0]
    for slot, g in enumerate(gid):
        if g >= 0:
            got.append((int(block_tile[slot // block]), g))
    assert sorted(got) == sorted((t, g) for t, _, g in expect)


def test_blocks_are_single_tile_and_depth_sorted(rng):
    _, _, _, proj, pb, tiles_x, tiles_y = _setup(rng)
    depth = np.asarray(proj.depth)
    gid = np.asarray(pb.gaussian_id)
    block_tile = np.asarray(pb.block_tile)
    num_tiles = tiles_x * tiles_y
    block = gid.shape[0] // block_tile.shape[0]

    per_tile_depths = {}
    for b in range(block_tile.shape[0]):
        t = int(block_tile[b])
        blk = gid[b * block:(b + 1) * block]
        if t == num_tiles:
            assert (blk == -1).all()  # padding blocks carry no pairs
            continue
        run = per_tile_depths.setdefault(t, [])
        for g in blk:
            if g >= 0:
                run.append(depth[g])
    for t, ds in per_tile_depths.items():
        assert all(a <= b for a, b in zip(ds, ds[1:])), f"tile {t} not sorted"


def test_padding_only_at_run_tails(rng):
    """Within one tile's run, all valid pairs precede all padding slots."""
    _, _, _, proj, pb, tiles_x, tiles_y = _setup(rng)
    gid = np.asarray(pb.gaussian_id)
    block_tile = np.asarray(pb.block_tile)
    num_tiles = tiles_x * tiles_y
    block = gid.shape[0] // block_tile.shape[0]
    for t in range(num_tiles):
        blocks = np.where(block_tile == t)[0]
        run = np.concatenate(
            [gid[b * block:(b + 1) * block] for b in blocks]
        ) if blocks.size else np.array([], np.int32)
        valid = run >= 0
        if valid.any():
            last = np.max(np.where(valid))
            assert valid[: last + 1].all()


def test_overflow_drops_whole_gaussians(rng):
    _, _, _, proj, pb, tiles_x, tiles_y = _setup(rng, pair_capacity=64)
    assert bool(pb.overflow)
    gid = np.asarray(pb.gaussian_id)
    kept = gid[gid >= 0]
    # every kept Gaussian appears with its FULL strip-clipped tile count
    expect = {}
    for t, _, g in _brute_force_pairs(proj, tiles_x, tiles_y):
        expect[g] = expect.get(g, 0) + 1
    counts = {}
    for g in kept:
        counts[g] = counts.get(g, 0) + 1
    for g, c in counts.items():
        assert c == expect[g], f"gaussian {g} partially dropped"


def test_strip_pairs_union_equals_full(rng):
    """Row strips partition the full pair set (multi-chip invariant)."""
    _, cam, cfg, proj, pb_full, tiles_x, tiles_y = _setup(rng)
    rows = 2
    parts = []
    for row0 in range(0, tiles_y, rows):
        pb = jax.jit(
            lambda p, r: pairs_mod.build_pairs(
                p, tiles_x, rows, cfg.pair_capacity, cfg.pair_block, row0=r
            )
        )(proj, jnp.int32(row0))
        gid = np.asarray(pb.gaussian_id)
        bt = np.asarray(pb.block_tile)
        block = gid.shape[0] // bt.shape[0]
        for slot, g in enumerate(gid):
            if g >= 0:
                local = int(bt[slot // block])
                ty = local // tiles_x + row0
                tx = local % tiles_x
                parts.append((ty * tiles_x + tx, int(g)))
    full = []
    gid = np.asarray(pb_full.gaussian_id)
    bt = np.asarray(pb_full.block_tile)
    block = gid.shape[0] // bt.shape[0]
    for slot, g in enumerate(gid):
        if g >= 0:
            full.append((int(bt[slot // block]), int(g)))
    assert sorted(parts) == sorted(full)


def test_impact_overflow_drop_keeps_highest_impact(rng):
    """overflow_drop="impact": under a forced overflow the surviving set is
    exactly the maximal descending (opacity x tiles) prefix that fits, and
    without overflow the plan matches the "index" mode bit-for-bit."""
    _, cam, _, proj, _, tiles_x, tiles_y = _setup(rng)
    full = pairs_mod.capacity_plan(proj, tiles_x, tiles_y, 1 << 20, 0)
    total_all = int(full[5])
    assert total_all > 8

    cap = max(total_all // 3, 1)
    plan_ix = pairs_mod.capacity_plan(proj, tiles_x, tiles_y, cap, 0, "index")
    plan_im = pairs_mod.capacity_plan(proj, tiles_x, tiles_y, cap, 0, "impact")
    assert bool(plan_ix[6]) and bool(plan_im[6])          # both overflowed
    counts_full = np.asarray(full[0])
    counts_im = np.asarray(plan_im[0])
    kept = counts_im > 0

    # survivors form the greedy maximal prefix by descending impact
    impact = np.asarray(proj.opacity) * counts_full
    order = np.argsort(-np.where(counts_full > 0, impact, -1.0), kind="stable")
    csum = np.cumsum(counts_full[order])
    ccsum = np.cumsum(-(-counts_full[order] // pairs_mod.PAIR_CHUNK))
    chunk_cap = pairs_mod._chunk_capacity(cap, counts_full.shape[0])
    want_kept = np.zeros_like(kept)
    want_kept[order] = (csum <= cap) & (ccsum <= chunk_cap)
    want_kept &= counts_full > 0
    np.testing.assert_array_equal(kept, want_kept & (counts_full > 0))

    assert counts_im.sum() <= cap

    # no overflow -> identical plans
    big_ix = pairs_mod.capacity_plan(proj, tiles_x, tiles_y, 1 << 20, 0, "index")
    big_im = pairs_mod.capacity_plan(proj, tiles_x, tiles_y, 1 << 20, 0, "impact")
    for a, b in zip(big_ix, big_im):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_impact_drop_renders_and_differentiates(rng, blend_interpret):
    """The impact drop composes with the full render + VJP."""
    from gaussiansplatting.ops.rasterize import render
    from conftest import make_camera_for_scene

    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=64, spread=0.7)
    sh = np.zeros((64, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    params = G.from_arrays(means, log_scales, quats, raw_op, sh)
    cam = make_camera_for_scene(width=64, height=48)
    cfg = RasterConfig(pair_capacity=64, pair_block=16, overflow_drop="impact")

    def loss(p):
        img, aux = render(p, cam, cfg)
        return jnp.sum(img ** 2), aux

    (val, aux), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True, allow_int=True)
    )(params)
    assert bool(aux.overflow)
    assert np.isfinite(float(val))
    assert np.isfinite(np.asarray(grads.means)).all()


def test_chunk_slack_reduces_rows_and_trips_overflow_cleanly(rng):
    """chunk_slack scales the expansion padding allowance; an undersized
    allowance trips the chunk-cap overflow path (whole-Gaussian drop),
    never an error, and slack=1.0 is the exact worst case."""
    _, cam, _, proj, _, tiles_x, tiles_y = _setup(rng)
    assert pairs_mod._chunk_capacity(4096, 1000, 0.5) < \
        pairs_mod._chunk_capacity(4096, 1000, 1.0)

    # with slack=1.0 nothing overflows at a generous pair cap
    full = pairs_mod.capacity_plan(proj, tiles_x, tiles_y, 1 << 20, 0)
    assert not bool(full[6])
    # zero slack at a pair cap equal to exact demand: padding pushes the
    # chunk demand past the allowance, and the plan reports overflow with
    # consistent (reduced) counts rather than failing
    total = int(full[5])
    tight = pairs_mod.capacity_plan(
        proj, tiles_x, tiles_y, total, 0, "index", 0.0
    )
    counts = np.asarray(tight[0])
    assert counts.sum() <= total
    if bool(tight[6]):
        assert counts.sum() < np.asarray(full[0]).sum()


@pytest.mark.parametrize("layout", ["sorted", "shuffled"])
@pytest.mark.parametrize("mode", ["sortprefix", "scatter"])
def test_cotangent_reduction_is_exact_per_gaussian(mode, layout):
    """Per-Gaussian cotangent sums carry only the f32 rounding of that
    Gaussian's own terms: one Gaussian with ~1e4-sized cotangents over many
    pairs must not swamp the ~1e-3-sized sums of the others (a difference
    of global prefix sums loses them entirely)."""
    rng = np.random.default_rng(7)
    n, d = 6, 9
    counts = np.array([4000, 3, 0, 17, 1, 250], np.int32)
    gid = np.concatenate([np.full(c, g, np.int32) for g, c in enumerate(counts)])
    gid = np.concatenate([gid, np.full(29, -1, np.int32)])      # padding slots
    if layout == "shuffled":
        gid = rng.permutation(gid)
    scale = np.where(gid == 0, 1e4, 1e-3)
    d_rows = (rng.normal(size=(d, gid.size)) * scale).astype(np.float32)
    d_rows[:, gid < 0] = 1e6                                    # never counted
    out = np.asarray(pairs_mod.reduce_aligned_cotangents(
        jnp.asarray(d_rows), jnp.asarray(gid), jnp.asarray(counts), n, mode))
    assert out.shape == (n, d)
    x = d_rows.astype(np.float64)
    for g in range(n):
        ref = x[:, gid == g].sum(axis=1)
        bound = 1e-6 * np.abs(x[:, gid == g]).sum(axis=1) + 1e-30
        assert (np.abs(out[g] - ref) <= bound).all(), (g, out[g], ref)
