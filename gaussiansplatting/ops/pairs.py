"""(tile, depth) pair expansion, sort, and block alignment — fixed shapes.

The reference generates pairs with a dynamic atomic write cursor
(generateTilePairs, tiled_shaders.metal:745-794), sorts 64-bit keys on the CPU
(tiled_rasterizer.mm:27-102) and binary-searches tile ranges
(buildTileRanges, sort.metal:553-589).  This module re-derives the same
result functionally, at static shapes:

  * the expansion gather runs at CHUNK granularity: each Gaussian's run is
    padded to multiples of ``PAIR_CHUNK`` pairs, per-run metadata + render
    data are gathered once per chunk (~8x fewer random indices than a
    per-pair gather) and broadcast to the chunk's lanes;
  * the render data rides the (tile, depth) sort as payload operands, so
    no aligned-order row gather is needed afterwards;
  * the block-aligned layout (every tile's run padded to a multiple of
    ``block`` so each render block touches one tile) is produced by a
    SECOND sort: each pair's aligned destination is computed with a cummax
    trick (no per-pair gathers), per-tile hole-filler elements are appended
    whose keys are exactly the padding positions, and sorting by destination
    materializes the aligned layout directly — no scatter;
  * the whole pipeline is wrapped in one custom VJP: the backward maps
    aligned-order cotangents to per-Gaussian sums either by sorting the
    cotangents by Gaussian id and taking a segmented scan over the
    now-contiguous runs (grad_reduce="sortprefix", deterministic) or by a
    single fused scatter-add (grad_reduce="scatter"), in place of the
    reference's relaxed float atomics (tiled_shaders.metal:698-736).

Everything is static-shape; overflow beyond ``pair_capacity`` drops whole
Gaussians exactly like the reference's bounds check
(tiled_shaders.metal:779-780).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussiansplatting.ops.projection import Projected


def _float0(x):
    import numpy as np

    return np.zeros(x.shape, jax.dtypes.float0)


# pairs per expansion chunk: the per-Gaussian metadata/render-data gather
# runs once per chunk, then broadcasts to the chunk's lanes
PAIR_CHUNK = 8


def _chunk_capacity(pair_capacity: int, n: int, slack: float = 1.0) -> int:
    """Static chunk-slot capacity: enough chunks for pair_capacity fully
    packed pairs plus per-Gaussian padding waste (< PAIR_CHUNK-1 each for up
    to n live Gaussians, capped so huge Gaussian capacities don't balloon
    the sort rows).

    ``slack`` scales the padding allowance: 1.0 covers the WORST case
    (every live Gaussian wastes a full chunk); typical waste is ~half, so
    at reference scale (1.5M Gaussians / 16M pairs) slack=0.5 cuts the fat
    sort from 28M to 22M rows.  An undersized allowance just trips the
    chunk-cap overflow path (whole-Gaussian drop + adaptive growth), never
    memory unsafety."""
    base = -(-pair_capacity // PAIR_CHUNK)
    return base + int(min(n, base) * slack)


def _run_ids(starts: jnp.ndarray, run_live: jnp.ndarray, num_slots: int) -> jnp.ndarray:
    """Map each slot to the id of the run covering it.

    Equivalent to ``searchsorted(cum, arange(num_slots), 'right')`` for runs
    with exclusive-prefix starts ``starts`` (strictly increasing over live
    runs), but built from one scatter-max + one cummax: XLA's searchsorted
    lowering is a per-query binary-search scan, far slower than this for
    millions of queries.
    """
    ids = jnp.arange(starts.shape[0], dtype=jnp.int32)
    dst = jnp.where(run_live, starts, num_slots)
    seed = jnp.full((num_slots,), -1, jnp.int32).at[dst].max(ids, mode="drop")
    return jax.lax.cummax(seed)


class PairRows(NamedTuple):
    """Block-aligned sorted pairs with their render data.

    gaussian_id: [aligned_cap] int32, -1 for padding slots.
    rows:        [D, aligned_cap] float32 per-pair data in aligned order
                 (column-major: each field is one lane-contiguous row).
    block_tile:  [num_blocks] int32 tile id per block (num_tiles = padding).
    num_pairs:   [] int32, pairs actually emitted (diagnostics / overflow).
    overflow:    [] bool, capacity was exceeded (some Gaussians dropped).
    """

    gaussian_id: jnp.ndarray
    rows: jnp.ndarray
    block_tile: jnp.ndarray
    num_pairs: jnp.ndarray
    overflow: jnp.ndarray


def aligned_capacity(pair_capacity: int, num_tiles: int, block: int) -> int:
    """Static capacity of the block-aligned array: every tile can waste at most
    block-1 slots of padding."""
    return pair_capacity + num_tiles * block


def capacity_plan(proj: Projected, tiles_x, tiles_y, pair_capacity, row0,
                  overflow_drop: str = "index", chunk_slack: float = 1.0):
    """Per-Gaussian pair/chunk counts with the capacity drop applied.

    Intersects each Gaussian's tile rect with the strip's row range, then
    drops Gaussians whose run would cross the end of either the real-pair
    or the chunk-slot capacity (reference: writePos + tileCount > maxPairs
    -> return, tiled_shaders.metal:779-780).

    ``overflow_drop`` picks WHICH Gaussians are dropped under overflow:

      * "index" (default, reference parity): whoever lands past the
        capacity prefix in emission (Gaussian index) order (the reference's
        atomic write cursor makes its drop set scheduling-dependent; a
        deterministic prefix is the closest reproducible analogue).
      * "impact": keep the highest-impact prefix instead, ranking by
        opacity x covered tiles, so CHRONIC overflow at a capped capacity
        sheds the least visible content rather than whole depth ranges.
        Costs two extra N-sized sort/scatter ops per frame; drops nothing
        when everything fits.

    Returns (counts, ccounts, coffsets, ty_lo, span_x, total, overflow).
    """
    n = proj.depth.shape[0]
    chunk_cap = _chunk_capacity(pair_capacity, n, chunk_slack)
    ty_lo = jnp.maximum(proj.tile_min[:, 1], row0)
    ty_hi = jnp.minimum(proj.tile_max[:, 1], row0 + tiles_y - 1)
    span_y = jnp.maximum(ty_hi - ty_lo + 1, 0)
    span_x = proj.tile_max[:, 0] - proj.tile_min[:, 0] + 1
    counts = jnp.where(proj.n_tiles > 0, span_x * span_y, 0).astype(jnp.int32)
    ccounts = -(-counts // PAIR_CHUNK)       # chunks per Gaussian
    cum = jnp.cumsum(counts)                 # inclusive (real pairs)
    offsets = cum - counts
    ccum = jnp.cumsum(ccounts)
    coffsets = ccum - ccounts
    total = cum[-1] if n > 0 else jnp.int32(0)
    ctotal = ccum[-1] if n > 0 else jnp.int32(0)

    if overflow_drop == "impact":
        # keep the max-impact set that fits BOTH caps: cumsum counts in
        # descending-impact order, keep while under capacity, scatter the
        # keep mask back to emission order
        impact = jnp.where(counts > 0, proj.opacity * counts, -1.0)
        order = jnp.argsort(-impact)
        fits_o = (jnp.cumsum(counts[order]) <= pair_capacity) & (
            jnp.cumsum(ccounts[order]) <= chunk_cap
        )
        fits = jnp.zeros((n,), bool).at[order].set(fits_o)
    else:
        fits = ((offsets + counts) <= pair_capacity) & (
            (coffsets + ccounts) <= chunk_cap
        )
    counts = jnp.where(fits, counts, 0)
    ccounts = jnp.where(fits, ccounts, 0)
    overflow = (total > pair_capacity) | (ctotal > chunk_cap)
    cum = jnp.cumsum(counts)
    coffsets = jnp.cumsum(ccounts) - ccounts
    total = jnp.minimum(cum[-1], pair_capacity) if n > 0 else jnp.int32(0)
    return counts, ccounts, coffsets, ty_lo, span_x, total, overflow


def build_pair_rows(
    proj: Projected,
    data: jnp.ndarray,       # [N, D] differentiable per-Gaussian render data
    tiles_x: int,
    tiles_y: int,
    pair_capacity: int,
    block: int,
    row0=0,
    grad_reduce: str = "sortprefix",
    overflow_drop: str = "index",
    chunk_slack: float = 1.0,
) -> PairRows:
    """Expand, sort, and block-align pairs, carrying ``data`` to every pair.

    ``tiles_y`` is the number of tile ROWS this call rasterizes and ``row0``
    the first (absolute) tile row — used by the tile-sharded multi-chip path
    where each device owns a horizontal strip.  Tile ids in the output are
    strip-local.  The per-Gaussian cull decisions (including the 256-tile
    cap) were made against the FULL image rect in projection, matching the
    reference; only pair emission is restricted to the strip.

    Differentiable in ``data`` only (the custom VJP reduces aligned-order
    cotangents to per-Gaussian sums); everything else is index machinery.
    """
    n = proj.depth.shape[0]
    row0 = jnp.asarray(row0, jnp.int32)
    plan = capacity_plan(proj, tiles_x, tiles_y, pair_capacity, row0,
                         overflow_drop, chunk_slack)
    counts, ccounts, coffsets, ty_lo, span_x, total, overflow = plan
    chunk_cap = _chunk_capacity(pair_capacity, n, chunk_slack)

    cfg = (int(n), int(pair_capacity), int(tiles_x), int(tiles_y),
           int(block), str(grad_reduce), int(chunk_cap))
    if grad_reduce == "autodiff":
        # plain-ops path (no custom VJP): forward-mode differentiable, used
        # by the JVP-vs-VJP AD consistency tests; its reverse-mode transpose
        # is a chain of per-stage scatters — correct but slow
        (gid_a, rows_a, block_tile, num_pairs), _ = _pair_rows_fwd(
            data, proj.depth, row0, total, counts, ccounts, coffsets, ty_lo,
            proj.tile_min[:, 0], span_x, cfg,
        )
    else:
        gid_a, rows_a, block_tile, num_pairs = _pair_rows(
            data, proj.depth, row0, total, counts, ccounts, coffsets, ty_lo,
            proj.tile_min[:, 0], span_x, cfg,
        )
    return PairRows(
        gaussian_id=gid_a,
        rows=rows_a,
        block_tile=block_tile,
        num_pairs=num_pairs,
        overflow=overflow,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(10,))
def _pair_rows(data, depth, row0, total, counts, ccounts, coffsets, ty_lo,
               tmin_x, span_x, cfg):
    out, _ = _pair_rows_fwd(
        data, depth, row0, total, counts, ccounts, coffsets, ty_lo, tmin_x,
        span_x, cfg,
    )
    return out


def _expand_and_sort1(data, depth, row0, counts, ccounts, coffsets, ty_lo,
                      tmin_x, span_x, cfg):
    """Two-tier expansion + the (tile, depth) payload sort.

    Returns (sorted_tile, sorted_gid, sorted_data tuple, e_cap)."""
    n, p_cap, tiles_x, tiles_y, block, _, chunk_cap = cfg[:7]
    num_tiles = tiles_x * tiles_y
    d = data.shape[-1]
    e_cap = chunk_cap * PAIR_CHUNK           # expansion rows (padded pairs)

    # ---- two-tier expansion: chunk slot -> Gaussian (gather), chunk ->
    #      PAIR_CHUNK lanes (broadcast).  The chunk-level gather touches
    #      ~8x fewer random indices than a per-pair gather ----
    cslots = jnp.arange(chunk_cap, dtype=jnp.int32)
    ctotal = jnp.minimum(
        (coffsets[-1] + ccounts[-1]) if n > 0 else jnp.int32(0), chunk_cap
    )
    cgid = _run_ids(coffsets, ccounts > 0, chunk_cap)
    cgid = jnp.clip(cgid, 0, n - 1)
    cvalid = cslots < ctotal

    # one chunk-level row-gather fetches rect metadata AND render data
    # (row width is free — the gather is latency-bound per index)
    table = jnp.concatenate(
        [
            coffsets.astype(jnp.float32)[:, None],
            counts.astype(jnp.float32)[:, None],
            span_x.astype(jnp.float32)[:, None],
            ty_lo.astype(jnp.float32)[:, None],
            tmin_x.astype(jnp.float32)[:, None],
            depth[:, None],
            data,
        ],
        axis=-1,
    )  # [N, 6 + D]; integer fields exact in fp32 (all < 2^24)
    crows = table[cgid]  # [chunk_cap, 6 + D]
    crank = cslots - crows[:, 0].astype(jnp.int32)

    def bcast(x):  # [chunk_cap] -> [e_cap] chunk-to-lane broadcast
        return jnp.broadcast_to(x[:, None], (chunk_cap, PAIR_CHUNK)).reshape(-1)

    lane = jnp.broadcast_to(
        jnp.arange(PAIR_CHUNK, dtype=jnp.int32)[None, :],
        (chunk_cap, PAIR_CHUNK),
    ).reshape(-1)
    rank = bcast(crank * PAIR_CHUNK) + lane
    count_p = bcast(crows[:, 1].astype(jnp.int32))
    span_p = jnp.maximum(bcast(crows[:, 2].astype(jnp.int32)), 1)
    slot_valid = bcast(cvalid) & (rank < count_p)

    ty = bcast(crows[:, 3].astype(jnp.int32)) + rank // span_p
    tx = bcast(crows[:, 4].astype(jnp.int32)) + rank % span_p
    depth_s = jnp.where(slot_valid, bcast(crows[:, 5]), jnp.inf)
    tile_id = jnp.where(
        slot_valid, (ty - row0) * tiles_x + tx, num_tiles
    ).astype(jnp.int32)
    gid_v = jnp.where(slot_valid, bcast(cgid), -1)

    # ---- sort #1: lexicographic by (tile, depth); the render data rides as
    #      payload operands ----
    ops = (tile_id, depth_s, gid_v) + tuple(
        bcast(crows[:, 6 + j]) for j in range(d)
    )
    s = jax.lax.sort(ops, num_keys=2)
    return s[0], s[2], s[3:], e_cap


def _tile_runs(sorted_tile, num_tiles, block):
    """Per-tile run starts/counts and their block-aligned layout.

    starts via searchsorted (num_tiles+1 queries is cheap; per-PAIR queries
    would not be, see _run_ids)."""
    q = jnp.arange(num_tiles + 1, dtype=jnp.int32)
    tile_starts_all = jnp.searchsorted(sorted_tile, q, side="left").astype(jnp.int32)
    tile_starts = tile_starts_all[:num_tiles]
    tile_counts = tile_starts_all[1:] - tile_starts
    aligned_counts = -(-tile_counts // block) * block
    aligned_cum = jnp.cumsum(aligned_counts)
    aligned_starts = aligned_cum - aligned_counts
    aligned_total = aligned_cum[-1] if num_tiles > 0 else jnp.int32(0)
    return tile_starts, tile_counts, aligned_counts, aligned_starts, aligned_total


def _block_tiles(aligned_starts, aligned_counts, aligned_total, num_tiles,
                 block, num_blocks):
    """Tile id of each aligned block (blocks never straddle tiles)."""
    block_starts = jnp.arange(num_blocks, dtype=jnp.int32) * block
    block_tile = _run_ids(aligned_starts // block, aligned_counts > 0, num_blocks)
    block_tile = jnp.where(
        block_starts < aligned_total,
        jnp.clip(block_tile, 0, num_tiles - 1),
        num_tiles,
    ).astype(jnp.int32)
    return block_tile


def _pair_rows_fwd(data, depth, row0, total, counts, ccounts, coffsets, ty_lo,
                   tmin_x, span_x, cfg):
    n, p_cap, tiles_x, tiles_y, block, _, chunk_cap = cfg[:7]
    num_tiles = tiles_x * tiles_y
    a_cap = aligned_capacity(p_cap, num_tiles, block)
    num_blocks = a_cap // block
    d = data.shape[-1]
    i32max = jnp.int32(2**31 - 1)

    sorted_tile, sorted_gid, sorted_data, e_cap = _expand_and_sort1(
        data, depth, row0, counts, ccounts, coffsets, ty_lo, tmin_x, span_x,
        cfg,
    )
    (tile_starts, tile_counts, aligned_counts, aligned_starts,
     aligned_total) = _tile_runs(sorted_tile, num_tiles, block)

    # ---- aligned destination per sorted pair WITHOUT per-pair gathers:
    #      apos = pos + shift[tile], and shift (cumulative padding inserted
    #      before the tile) is non-decreasing over the sorted order, so a
    #      tiny scatter at run starts + cummax broadcasts it ----
    shift_t = aligned_starts - tile_starts          # [T] >= 0, non-decreasing
    seed = jnp.zeros((e_cap,), jnp.int32).at[
        jnp.where(tile_counts > 0, tile_starts, e_cap)
    ].max(shift_t, mode="drop")
    shift = jax.lax.cummax(seed)
    pos = jnp.arange(e_cap, dtype=jnp.int32)
    live = pos < total        # real pairs sort before all invalid pad rows
    apos = jnp.where(live, pos + shift, i32max)

    # ---- hole fillers: tile t needs (aligned - count) pads at positions
    #      [start + count, start + aligned_count) — at most block-1 each ----
    pad_lane = jnp.arange(block - 1, dtype=jnp.int32)[None, :]
    pad_apos = aligned_starts[:, None] + tile_counts[:, None] + pad_lane
    pad_ok = pad_lane < (aligned_counts - tile_counts)[:, None]
    pad_apos = jnp.where(pad_ok, pad_apos, i32max).reshape(-1)   # [T*(B-1)]
    n_pad = pad_apos.shape[0]

    # ---- sort #2 by destination: pairs land in their aligned slots, pads
    #      fill the holes, everything else parks past aligned_total ----
    key2 = jnp.concatenate([apos, pad_apos])
    gid2 = jnp.concatenate([sorted_gid, jnp.full((n_pad,), -1, jnp.int32)])
    ops2 = (key2, gid2) + tuple(
        jnp.concatenate([col, jnp.zeros((n_pad,), col.dtype)])
        for col in sorted_data
    )
    s2 = jax.lax.sort(ops2, num_keys=1)
    l2 = key2.shape[0]

    out_pos = jnp.arange(l2, dtype=jnp.int32)
    in_aligned = out_pos < aligned_total
    gid_aligned = jnp.where(in_aligned, s2[1], -1)
    # column-major [D, l2]: stacking 1-D sort outputs along a NEW LEADING
    # axis is a plain memcpy
    rows_aligned = jnp.stack(s2[2:], axis=0)

    pad_tail = a_cap - l2
    if pad_tail > 0:
        gid_aligned = jnp.concatenate(
            [gid_aligned, jnp.full((pad_tail,), -1, jnp.int32)]
        )
        rows_aligned = jnp.concatenate(
            [rows_aligned, jnp.zeros((d, pad_tail), rows_aligned.dtype)],
            axis=1,
        )
    else:
        gid_aligned = gid_aligned[:a_cap]
        rows_aligned = rows_aligned[:, :a_cap]

    block_tile = _block_tiles(
        aligned_starts, aligned_counts, aligned_total, num_tiles, block,
        num_blocks,
    )

    out = (gid_aligned, rows_aligned, block_tile, total)
    return out, (gid_aligned, counts)


def reduce_aligned_cotangents(d_rows, gid_aligned, counts, n,
                              grad_reduce="sortprefix"):
    """Per-Gaussian sums of aligned-order cotangents d_rows [D, a_cap]
    (the deterministic replacement for the reference's per-field atomics,
    tiled_shaders.metal:698-736).  Returns [N, D]."""
    d = d_rows.shape[0]
    if grad_reduce == "scatter":
        # one fused duplicate-index scatter-add
        return jnp.zeros((n, d), d_rows.dtype).at[
            jnp.where(gid_aligned >= 0, gid_aligned, n)
        ].add(d_rows.T, mode="drop")
    # sortprefix: sort cotangents by Gaussian id, then each Gaussian's sum is
    # a segmented scan over its contiguous run, read at the run's end (an
    # N-index row gather of an [a_cap, D] table).  The scan restarts at every
    # run: differences of one global prefix sum would cancel catastrophically
    # (at tens of millions of pairs the running sum's f32 rounding exceeds
    # most Gaussians' whole gradient).
    key = jnp.where(gid_aligned >= 0, gid_aligned, n)
    s = jax.lax.sort((key,) + tuple(d_rows[j] for j in range(d)), num_keys=1)
    skey, sd = s[0], jnp.stack(s[1:], axis=-1)        # [a_cap], [a_cap, D]
    start = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])

    def combine(a, b):
        start_a, sum_a = a
        start_b, sum_b = b
        return start_a | start_b, jnp.where(start_b[:, None], sum_b, sum_a + sum_b)

    _, incl = jax.lax.associative_scan(combine, (start, sd))
    ends = jnp.cumsum(counts)                         # [N] run ends (1-based)
    return jnp.where((counts > 0)[:, None], incl[jnp.maximum(ends - 1, 0)], 0.0)


def _pair_rows_bwd(cfg, res, cts):
    n, p_cap, tiles_x, tiles_y, block, grad_reduce = cfg[:6]
    gid_aligned, counts = res
    d_rows = cts[1]                                   # [D, a_cap]
    d_data = reduce_aligned_cotangents(
        d_rows, gid_aligned, counts, n, grad_reduce
    )

    zero_i32 = lambda shape: _float0(jnp.zeros(shape, jnp.int32))  # noqa: E731
    return (
        d_data,
        jnp.zeros((n,), jnp.float32),   # depth (sort keys carry no gradient)
        _float0(jnp.zeros((), jnp.int32)),   # row0
        _float0(jnp.zeros((), jnp.int32)),   # total
        zero_i32((n,)),                 # counts
        zero_i32((n,)),                 # ccounts
        zero_i32((n,)),                 # coffsets
        zero_i32((n,)),                 # ty_lo
        zero_i32((n,)),                 # tmin_x
        zero_i32((n,)),                 # span_x
    )


_pair_rows.defvjp(_pair_rows_fwd, _pair_rows_bwd)


def build_pairs(
    proj: Projected,
    tiles_x: int,
    tiles_y: int,
    pair_capacity: int,
    block: int,
    row0=0,
) -> PairRows:
    """Index-only variant (no render data) for tests and profiling; the
    layout invariants are identical to build_pair_rows."""
    return build_pair_rows(
        proj, proj.depth[:, None], tiles_x, tiles_y, pair_capacity, block,
        row0=row0,
    )
