"""Differentiable tiled rasterizer — block-parallel alpha blending.

The reference walks each pixel serially through its tile's depth-sorted
Gaussians (tiled_shaders.metal:307-385) and hand-derives a transmittance-replay
backward with atomic float accumulation (tiled_shaders.metal:388-738).  Here
alpha compositing is used as *associative* in (color, transmittance) space:
a run of Gaussians composes to a pair (C, T) and two runs combine as
(C1 + T1*C2, T1*T2).  So:

  * pairs are grouped into fixed-size blocks of B Gaussians per 16x16 tile
    (ops/pairs.py guarantees one tile per block);
  * the quadratic form -0.5 d^T conic d expands into 6 pixel monomials
    (x2, xy, y2, x, y, 1) in tile-local coordinates times 6 per-Gaussian
    coefficients, so a block's 256 x B powers are 6 multiply-adds each;
  * each block blends independently: on the GPU in the fused Pallas-Triton
    kernels of ops/pallas_blend.py, elsewhere (and as their reference) in a
    chunked XLA scan where the in-block front-to-back blend is a log-space
    cumulative sum (T_k = exp(cumsum log(1-alpha)));
  * blocks compose across a tile with a segmented prefix over block summaries
    (C_b, S_b = sum log(1-alpha)) — cheap, parallel, deterministic;
  * the XLA path's backward is jax.grad: jax.checkpoint on the per-chunk
    blend re-materializes block internals, which IS the reference's
    transmittance replay, with deterministic per-Gaussian gradient
    reduction instead of atomics.

Numerics: powers are evaluated in tile-local coordinates (pixel offsets in
[-7.5, 7.5]) so the expanded form loses no precision vs the reference's
direct d^T conic d; the per-pair constant term is one fp32 quadratic-form evaluation,
identical to the reference's per-pixel evaluation error profile.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussiansplatting.config import RasterConfig
from gaussiansplatting.core.camera import Camera
from gaussiansplatting.core.gaussians import GaussianParams
from gaussiansplatting.ops import pairs as pairs_mod
from gaussiansplatting.ops import projection as proj_mod


class RenderAux(NamedTuple):
    num_pairs: jnp.ndarray   # [] int32 pairs emitted this frame
    overflow: jnp.ndarray    # [] bool pair capacity exceeded


def _pixel_features(tile_size: int) -> jnp.ndarray:
    """[tile_size^2, 6] monomials (x2, xy, y2, x, y, 1) of tile-local pixel
    centers; identical for every tile, so computed once at trace time."""
    half = tile_size / 2.0
    coords = jnp.arange(tile_size, dtype=jnp.float32) + 0.5 - half
    y, x = jnp.meshgrid(coords, coords, indexing="ij")  # row-major pixel order
    x = x.reshape(-1)
    y = y.reshape(-1)
    return jnp.stack([x * x, x * y, y * y, x, y, jnp.ones_like(x)], axis=-1)


def _color_with_dead_zone(raw_color: jnp.ndarray) -> jnp.ndarray:
    """clamp(SH_C0*dc + 0.5, 0, 1) whose gradient is zeroed outside
    (0.01, 0.99) — the reference zeroes dL/dColor at those margins to stop
    pushing saturated colors further (tiled_shaders.metal:505-507)."""
    c = jnp.clip(raw_color, 0.0, 1.0)
    live = (c > 0.01) & (c < 0.99)
    return jnp.where(live, c, jax.lax.stop_gradient(c))


def quad_terms(mx, my, a, b, c):
    """The six coefficients of the quadratic form -0.5 d^T conic d expanded
    over the pixel monomials (x2, xy, y2, x, y, 1) in tile-local coords.
    Shared by the XLA blend and the Pallas kernel, so both round alike."""
    return (
        -0.5 * a,
        -b,
        -0.5 * c,
        a * mx + b * my,
        b * mx + c * my,
        -0.5 * (a * mx * mx + 2.0 * b * mx * my + c * my * my),
    )


def _quad_coefs(mu: jnp.ndarray, conic: jnp.ndarray) -> jnp.ndarray:
    """[..., 6] stacked quad_terms of per-pair mu [..., 2], conic [..., 3]."""
    return jnp.stack(
        quad_terms(mu[..., 0], mu[..., 1],
                   conic[..., 0], conic[..., 1], conic[..., 2]),
        axis=-1,
    )


def _powers(mu: jnp.ndarray, conic: jnp.ndarray, feats: jnp.ndarray):
    """[blocks, P2, B] quadratic-form powers: six f32 multiply-adds per
    pixel, summed in the order the Pallas kernel uses (K=6 is too thin for
    a matrix unit)."""
    coef = _quad_coefs(mu, conic)[:, None, :, :]  # [blocks, 1, B, 6]
    f = feats[None, :, None, :]                    # [1, P2, 1, 6]
    power = coef[..., 0] * f[..., 0]
    for k in range(1, 6):
        power = power + coef[..., k] * f[..., k]
    return power


def _block_blend(
    mu: jnp.ndarray,       # [blocks, B, 2] screen pos relative to tile center
    conic: jnp.ndarray,    # [blocks, B, 3]
    opacity: jnp.ndarray,  # [blocks, B]
    color: jnp.ndarray,    # [blocks, B, 3]
    valid: jnp.ndarray,    # [blocks, B]
    feats: jnp.ndarray,    # [P2, 6] pixel monomials (P2 = tile_size^2)
    cfg: RasterConfig,
    logti: jnp.ndarray | None = None,  # [blocks, P2] incoming log T (t-floor)
):
    """Blend each block independently; returns per-block summaries
    (C_b [blocks, P2, 3], S_b [blocks, P2])."""
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    power = _powers(mu, conic, feats)
    g = jnp.exp(power)
    raw_alpha = opacity[:, None, :] * g
    # alpha cap: forward min(., 0.99) but gradient flows as if uncapped
    # (the reference backward ignores the cap, tiled_shaders.metal:493,518).
    alpha = raw_alpha + jax.lax.stop_gradient(
        jnp.minimum(raw_alpha, cfg.alpha_cap) - raw_alpha
    )
    conic_mag = jnp.abs(a) + jnp.abs(b) + jnp.abs(c)  # [blocks, B]
    mask = (
        valid[:, None, :]
        & (conic_mag[:, None, :] >= 1e-4)          # tiled_shaders.metal:350-351
        & (power <= 0.0)                           # skip power > 0
        & (power >= cfg.power_floor)               # skip power < -4.5
        & (alpha >= cfg.alpha_floor)               # skip alpha < 1/255
    )
    alpha = jnp.where(mask, alpha, 0.0)

    if logti is not None:
        # exact early-termination parity (tiled_shaders.metal:334): zero
        # pairs whose incoming global transmittance fell below the floor;
        # survivors' prefixes only contain survivors, so their weights are
        # unchanged.  The mask is constant w.r.t. gradients.
        l0 = jnp.log1p(-alpha)
        log_excl = jnp.cumsum(l0, axis=-1) - l0
        mask_t = jax.lax.stop_gradient(
            (log_excl + logti[:, :, None])
            > jnp.log(cfg.transmittance_floor)
        )
        alpha = jnp.where(mask_t, alpha, 0.0)

    log1m = jnp.log1p(-alpha)                      # >= log(0.01), finite
    t_local = jnp.exp(jnp.cumsum(log1m, axis=-1) - log1m)  # exclusive prefix
    weight = alpha * t_local                       # [blocks, P2, B]

    c_b = jnp.einsum(
        "kpb,kbc->kpc", weight, color, preferred_element_type=jnp.float32
    )
    s_b = jnp.sum(log1m, axis=-1)                  # [blocks, P2]
    return c_b, s_b


def render(
    params: GaussianParams,
    camera: Camera,
    cfg: RasterConfig,
    vs_dummy: jnp.ndarray | None = None,
    chunk_blocks: int = 256,
    tile_rows: tuple | None = None,
):
    """Render one view.  Returns (image [H, W, 3] float32, RenderAux).

    vs_dummy: optional [N, 2] zeros added to projected screen positions; its
    cotangent is the per-Gaussian view-space positional gradient the density
    controller accumulates (reference: gradients.viewspace_grad_*,
    tiled_shaders.metal:717-720).

    tile_rows: optional (row0, n_rows) — rasterize only tile rows
    [row0, row0+n_rows) and return a [n_rows*tile_size, W, 3] strip.  n_rows
    must be a static int; row0 may be traced (the multi-chip path derives it
    from the device index).  Cull/pair semantics are identical to the full
    render restricted to the strip.
    """
    width, height = camera.width, camera.height
    ts = cfg.tile_size
    tiles_x = proj_mod.num_tiles(width, ts)
    tiles_y_img = proj_mod.num_tiles(height, ts)
    if tile_rows is None:
        row0, tiles_y = 0, tiles_y_img
    else:
        row0, tiles_y = tile_rows
    num_tiles_total = tiles_x * tiles_y
    p2 = ts * ts
    block = cfg.pair_block

    proj = proj_mod.project(params, camera, cfg)
    screen_pos = proj.screen_pos
    if vs_dummy is not None:
        screen_pos = screen_pos + vs_dummy
    color = _color_with_dead_zone(proj.color)

    # per-Gaussian render data rides the pair sorts as payload; the custom
    # VJP inside build_pair_rows reduces aligned-order cotangents straight
    # back to per-Gaussian sums (the deterministic replacement for the
    # reference's per-field atomics, tiled_shaders.metal:698-736)
    data = jnp.concatenate(
        [screen_pos, proj.conic, proj.opacity[:, None], color], axis=-1
    )  # [N, 9]

    pair_blocks = pairs_mod.build_pair_rows(
        proj, data, tiles_x, tiles_y, cfg.pair_capacity, block, row0=row0,
        grad_reduce=cfg.grad_reduce, overflow_drop=cfg.overflow_drop,
        chunk_slack=cfg.chunk_slack,
    )
    a_cap = pair_blocks.gaussian_id.shape[0]
    num_blocks = a_cap // block

    gid = pair_blocks.gaussian_id.reshape(num_blocks, block)
    pair_valid = gid >= 0

    block_tile = jnp.minimum(pair_blocks.block_tile, num_tiles_total - 1)
    row0_f = jnp.asarray(row0, jnp.float32)
    tile_cx = (block_tile % tiles_x).astype(jnp.float32) * ts + ts / 2.0
    tile_cy = ((block_tile // tiles_x).astype(jnp.float32) + row0_f) * ts + ts / 2.0
    tile_center = jnp.stack([tile_cx, tile_cy], axis=-1)  # [NB, 2]

    # column-major pair data: each field reshapes to [NB, B] for free
    # (the blend reads each field as one contiguous [NB, B] array)
    def col(i):
        return pair_blocks.rows[i].reshape(num_blocks, block)

    mu_x = col(0) - tile_center[:, 0:1]
    mu_y = col(1) - tile_center[:, 1:2]
    c_a, c_bb, c_c = col(2), col(3), col(4)
    b_opacity = col(5)
    col_r, col_g, col_b = col(6), col(7), col(8)

    # ---- per-block blended summaries ----
    feats = _pixel_features(ts)
    mu = jnp.stack([mu_x, mu_y], axis=-1)
    b_conic = jnp.stack([c_a, c_bb, c_c], axis=-1)
    b_color = jnp.stack([col_r, col_g, col_b], axis=-1)
    chunk_blocks = min(chunk_blocks, num_blocks)
    n_chunks = -(-num_blocks // chunk_blocks)
    nb_pad = n_chunks * chunk_blocks

    def chunk(x):
        pad = [(0, nb_pad - num_blocks)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad).reshape((n_chunks, chunk_blocks) + x.shape[1:])

    def blend_xla(logti=None):
        """Chunked scan of _block_blend; jax.checkpoint re-materialises the
        block internals in the backward (the transmittance replay).
        Returns channel-first (C_b [NB, 3, P2], S_b [NB, P2])."""
        def chunk_fn(_, args):
            *blend_args, lt = args
            return None, _block_blend(*blend_args, feats, cfg, logti=lt)

        chunked = jax.tree_util.tree_map(
            chunk, (mu, b_conic, b_opacity, b_color, pair_valid, logti)
        )
        _, (c, s) = jax.lax.scan(jax.checkpoint(chunk_fn), None, chunked)
        return (
            c.reshape(nb_pad, p2, 3)[:num_blocks].transpose(0, 2, 1),
            s.reshape(nb_pad, p2)[:num_blocks],
        )

    if _use_kernel(cfg.blend_impl):
        # fused Pallas-Triton kernels (ops/pallas_blend.py): the nine
        # [NB, B] columns in, [NB, 4, P2] out; the backward returns [NB, B]
        # column cotangents that flow straight into the pair pipeline's VJP
        from gaussiansplatting.ops.pallas_blend import block_blend_cols

        conic_mag = jnp.abs(c_a) + jnp.abs(c_bb) + jnp.abs(c_c)
        op_eff = jnp.where(pair_valid & (conic_mag >= 1e-4), b_opacity, 0.0)
        out = block_blend_cols(
            mu_x, mu_y, c_a, c_bb, c_c, op_eff, col_r, col_g, col_b,
            (ts, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor),
        )                                                    # [NB, 4, P2]
        c_b, s_b = out[:, :3, :], out[:, 3, :]
    else:
        c_b, s_b = blend_xla()

    # ---- compose blocks within each tile ----
    seg = pair_blocks.block_tile  # [NB], == num_tiles_total for padding blocks
    return _compose_tiles(
        c_b, s_b, seg, blend_xla, num_tiles_total, tiles_x,
        tiles_y, ts, p2, width, height, cfg, tile_rows,
        RenderAux(num_pairs=pair_blocks.num_pairs,
                  overflow=pair_blocks.overflow),
    )


def _use_kernel(blend_impl: str) -> bool:
    """"auto" takes the Pallas-Triton blend on the GPU and the XLA scan
    elsewhere; "xla" always takes the scan."""
    if blend_impl == "auto":
        return jax.default_backend() == "gpu"
    if blend_impl == "xla":
        return False
    raise ValueError(f"unknown blend_impl {blend_impl!r}")


def _compose_tiles(c_b, s_b, seg, blend_tfloor, num_tiles_total,
                   tiles_x, tiles_y, ts, p2, width, height, cfg, tile_rows,
                   aux):
    """Segmented exclusive-prefix composition of per-block summaries into
    the image (the associative (C, T) combine across a tile's blocks).

    A tile's blocks are contiguous (ops/pairs.py), so each block's incoming
    log-transmittance is the sum of S over the earlier blocks of its own
    tile: a segmented scan that restarts at every tile.  (A global cumsum
    over all blocks minus the value at the tile's first block would cancel
    catastrophically: the running sum reaches ~1e6 at real sizes, so its f32
    rounding alone moves log T by ~0.1.)"""
    start = jnp.concatenate([jnp.ones((1,), bool), seg[1:] != seg[:-1]])

    def combine(a, b):
        start_a, sum_a = a
        start_b, sum_b = b
        return start_a | start_b, jnp.where(start_b[:, None], sum_b, sum_a + sum_b)

    _, incl = jax.lax.associative_scan(combine, (start, s_b))   # [NB, P2]
    log_t_in = jnp.where(
        start[:, None], 0.0, jnp.concatenate([jnp.zeros_like(incl[:1]), incl[:-1]])
    )
    t_in = jnp.exp(log_t_in)

    if cfg.t_floor_exact:
        # second pass with the per-block incoming log-transmittance: pairs
        # past the per-pixel termination point are zeroed and T freezes for
        # the background, exactly like tiled_shaders.metal:334.  The mask is
        # constant w.r.t. gradients (reference parity), hence stop_gradient;
        # t_in itself stays differentiable below.
        logti = jax.lax.stop_gradient(log_t_in)
        c_b, s_b_masked = blend_tfloor(logti)
        tile_log_t_src = s_b_masked
    else:
        tile_log_t_src = s_b

    contrib = t_in[:, None, :] * c_b  # [NB, 3, P2] (channel-first, no relayout)
    tile_color = jax.ops.segment_sum(contrib, seg, num_segments=num_tiles_total + 1)
    tile_log_t = jax.ops.segment_sum(
        tile_log_t_src, seg, num_segments=num_tiles_total + 1
    )
    tile_color = tile_color[:num_tiles_total]
    tile_log_t = tile_log_t[:num_tiles_total]

    bg = 1.0 if cfg.white_background else 0.0
    tile_img = tile_color + jnp.exp(tile_log_t)[:, None, :] * bg  # [T, 3, P2]

    # ---- tiles -> image (full image: crop to H x W; strip: keep padded rows
    #      so every device's strip has identical static shape); the
    #      channel-minor transpose is T*P2*3 elements — tiny ----
    img = tile_img.reshape(tiles_y, tiles_x, 3, ts, ts)
    img = img.transpose(0, 3, 1, 4, 2).reshape(tiles_y * ts, tiles_x * ts, 3)
    if tile_rows is None:
        img = img[:height, :width]
    else:
        img = img[:, :width]

    return img, aux
