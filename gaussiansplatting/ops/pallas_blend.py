"""Fused block blend for the GPU: Pallas kernels on the Triton route.

The counterpart of the reference's tiledForward / tiledBackward kernels
(tiled_shaders.metal:307-385, 388-738) for the block-aligned pair layout of
ops/pairs.py.  The XLA path in ops/rasterize.py materialises every
[blocks, P2, B] intermediate (power, alpha, log(1-alpha), the cumulative sum,
the weights) in device memory, in the forward and again in the checkpointed
backward.  Here one program blends one block of B depth-sorted Gaussians
over its P2 = tile_size^2 pixels with the per-pixel state in registers: the
kernels read the nine [NB, B] pair columns and write [NB, 4, P2] (forward)
or nine [NB, B] column cotangents (backward), nothing else.

Per Gaussian j of the block (a loop over j, scalars loaded per step):

  * power   = six per-pair coefficients of -0.5 d^T conic d against the
              pixel monomials (x^2, xy, y^2, x, y, 1): 6 f32 FMAs per pixel;
  * alpha   = min(op * exp(power), alpha_cap) under the exact masks of
              rasterize._block_blend (power window, alpha floor; the conic
              magnitude and pair validity are folded into ``op`` by the
              caller); the cap passes the gradient straight through;
  * front-to-back: C += alpha * T * color, S += log(1 - alpha),
              T *= 1 - alpha (the sequential transmittance product).

The backward replays the block front to back once more.  The suffix sum
sum_{k>j} e_k w_k that the transmittance gradient needs is taken as the
block total (g_C . C_b, from the saved forward output) minus the running
prefix, so no pass runs back to front and T is never divided back (dividing
loses T entirely once it underflows behind ~19 capped Gaussians).  Its
absolute error is a few f32 ulps of sum_k |e_k w_k|.  The per-Gaussian
gradients are reduced across the block's pixels inside the program: no
atomics, deterministic.

Loops stop after the block's last Gaussian with positive opacity: padding
slots and padding blocks (op == 0) can never pass the alpha floor, so
skipping them changes no value and no gradient.

Interpret mode (``interpret=True``) runs the same kernels in the Pallas
interpreter on any backend; only tests ask for it.  Without it the kernels
compile for the GPU only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from gaussiansplatting.ops.rasterize import quad_terms

# one warp per block: the 256-pixel state fits its registers, and the
# per-Gaussian reductions are warp shuffles with no shared-memory barrier
NUM_WARPS = 1


def _pixels(ts: int):
    """Tile-local pixel monomials (x^2, xy, y^2, x, y) of the P2 pixel
    centers, row-major (matches rasterize._pixel_features)."""
    p2 = ts * ts
    pix = jax.lax.broadcasted_iota(jnp.int32, (p2,), 0)
    shift = ts.bit_length() - 1
    half = ts / 2.0
    x = (pix & (ts - 1)).astype(jnp.float32) + (0.5 - half)
    y = (pix >> shift).astype(jnp.float32) + (0.5 - half)
    return x * x, x * y, y * y, x, y


def _live_count(op_ref):
    """1 + index of the block's last Gaussian with positive opacity."""
    op = op_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, op.shape, 0)
    return jnp.max(jnp.where(op > 0.0, lane + 1, 0))


def _alpha(j, col_refs, feats, consts):
    """Replay pair j: returns (alpha, mask, g = exp(power), a_raw) and the
    pair's scalars."""
    power_floor, alpha_cap, alpha_floor = consts
    x2, xy, y2, x, y = feats
    mx, my, a, b, c, op, cr, cg, cb = (r[j] for r in col_refs)
    k0, k1, k2, k3, k4, k5 = quad_terms(mx, my, a, b, c)
    power = k0 * x2 + k1 * xy + k2 * y2 + k3 * x + k4 * y + k5
    g = jnp.exp(power)
    a_raw = op * g
    mask = (power <= 0.0) & (power >= power_floor) & (a_raw >= alpha_floor)
    alpha = jnp.where(mask, jnp.minimum(a_raw, alpha_cap), 0.0)
    return alpha, mask, g, a_raw, (mx, my, a, b, c, op, cr, cg, cb)


def _fwd_kernel(*refs, ts, consts):
    col_refs, out_ref = refs[:9], refs[9]
    feats = _pixels(ts)
    zero = jnp.zeros((ts * ts,), jnp.float32)

    def body(j, carry):
        t, c_r, c_g, c_b, s = carry
        alpha, _, _, _, pair = _alpha(j, col_refs, feats, consts)
        cr, cg, cb = pair[6:]
        w = alpha * t
        return (t * (1.0 - alpha), c_r + w * cr, c_g + w * cg,
                c_b + w * cb, s + jnp.log1p(-alpha))

    _, c_r, c_g, c_b, s = jax.lax.fori_loop(
        0, _live_count(col_refs[5]), body, (zero + 1.0, zero, zero, zero, zero)
    )
    out_ref[0, :] = c_r
    out_ref[1, :] = c_g
    out_ref[2, :] = c_b
    out_ref[3, :] = s


def _bwd_kernel(*refs, ts, consts):
    col_refs = refs[:9]
    out_ref, g_ref = refs[9], refs[10]
    d_refs = refs[11:]
    feats = _pixels(ts)
    x2, xy, y2, x, y = feats
    b = col_refs[0].shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (b,), 0)
    gc_r, gc_g, gc_b, g_s = g_ref[0, :], g_ref[1, :], g_ref[2, :], g_ref[3, :]
    # sum_k e_k w_k over the whole block, from the forward's C_b
    total = gc_r * out_ref[0, :] + gc_g * out_ref[1, :] + gc_b * out_ref[2, :]

    def body(j, carry):
        t, prefix, acc = carry
        alpha, mask, g, a_raw, pair = _alpha(j, col_refs, feats, consts)
        mx, my, a, b_, c, _, cr, cg, cb = pair
        w = alpha * t
        e = gc_r * cr + gc_g * cg + gc_b * cb
        ew = e * w
        # dL/dlog(1-alpha_j) = sum_{k>j} e_k w_k + dL/dS
        dl = (total - prefix - ew) + g_s
        da = jnp.where(mask, e * t - dl / (1.0 - alpha), 0.0)
        dpow = da * a_raw
        d0 = jnp.sum(dpow * x2)
        d1 = jnp.sum(dpow * xy)
        d2 = jnp.sum(dpow * y2)
        d3 = jnp.sum(dpow * x)
        d4 = jnp.sum(dpow * y)
        d5 = jnp.sum(dpow)
        # chain dL/dcoef back to the five geometry columns
        d_mx = a * d3 + b_ * d4 - (a * mx + b_ * my) * d5
        d_my = b_ * d3 + c * d4 - (b_ * mx + c * my) * d5
        d_a = -0.5 * d0 + mx * d3 - 0.5 * mx * mx * d5
        d_b = -d1 + my * d3 + mx * d4 - mx * my * d5
        d_c = -0.5 * d2 + my * d4 - 0.5 * my * my * d5
        d_op = jnp.sum(da * g)
        d_cr = jnp.sum(gc_r * w)
        d_cg = jnp.sum(gc_g * w)
        d_cb = jnp.sum(gc_b * w)
        hit = lane == j
        acc = tuple(
            jnp.where(hit, v, old)
            for v, old in zip(
                (d_mx, d_my, d_a, d_b, d_c, d_op, d_cr, d_cg, d_cb), acc
            )
        )
        return t * (1.0 - alpha), prefix + ew, acc

    zero_p = jnp.zeros((ts * ts,), jnp.float32)
    zero_b = jnp.zeros((b,), jnp.float32)
    _, _, acc = jax.lax.fori_loop(
        0, _live_count(col_refs[5]), body,
        (zero_p + 1.0, zero_p, (zero_b,) * 9),
    )
    for r, v in zip(d_refs, acc):
        r[...] = v


def _check_shapes(cols, ts):
    nb, b = cols[0].shape
    for c in cols:
        if c.shape != (nb, b) or c.dtype != jnp.float32:
            raise ValueError(
                f"blend columns must all be float32 [{nb}, {b}], got "
                f"{c.dtype}{list(c.shape)}"
            )
    for name, v in (("pair_block", b), ("tile_size", ts)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"the Triton blend needs a power-of-two {name}, got {v}")


def _call(kernel, name, cols, extra, out_shapes, cfg_consts, interpret):
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Pallas-Triton blend compiles for the GPU only; on "
            f"{jax.default_backend()!r} the renderer takes the XLA blend "
            "(tests may pass interpret=True)"
        )
    ts = int(cfg_consts[0])
    _check_shapes(cols, ts)
    nb, b = cols[0].shape
    p2 = ts * ts
    col_spec = pl.BlockSpec((None, b), lambda i: (i, 0))
    img_spec = pl.BlockSpec((None, 4, p2), lambda i: (i, 0, 0))
    spec = {(b,): col_spec, (4, p2): img_spec}
    return pl.pallas_call(
        functools.partial(kernel, ts=ts, consts=tuple(cfg_consts[1:4])),
        grid=(nb,),
        in_specs=[col_spec] * 9 + [img_spec] * len(extra),
        out_specs=tuple(spec[s] for s in out_shapes),
        out_shape=tuple(
            jax.ShapeDtypeStruct((nb,) + s, jnp.float32) for s in out_shapes
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=name,
    )(*cols, *extra)


@functools.partial(jax.custom_vjp, nondiff_argnums=(9, 10))
def block_blend_cols(mux, muy, ca, cb, cc, op, cr, cg, cbl, cfg_consts,
                     interpret=False):
    """Blend from the nine raw pair columns, each [NB, B] float32:
    tile-local mean x/y, conic a/b/c, effective opacity (0 for invalid
    pairs), color r/g/b.  cfg_consts is the static tuple (tile_size,
    power_floor, alpha_cap, alpha_floor).  Returns out [NB, 4, P2]: rows 0-2
    = blended color C_b, row 3 = S_b (sum of log(1-alpha))."""
    out, _ = _fwd(mux, muy, ca, cb, cc, op, cr, cg, cbl, cfg_consts, interpret)
    return out


def _fwd(mux, muy, ca, cb, cc, op, cr, cg, cbl, cfg_consts, interpret):
    cols = (mux, muy, ca, cb, cc, op, cr, cg, cbl)
    p2 = int(cfg_consts[0]) ** 2
    (out,) = _call(_fwd_kernel, "gs_blend_fwd", cols, (), [(4, p2)],
                   cfg_consts, interpret)
    return out, (cols, out)


def _bwd(cfg_consts, interpret, residuals, g):
    cols, out = residuals
    b = cols[0].shape[1]
    return _call(_bwd_kernel, "gs_blend_bwd", cols, (out, g), [(b,)] * 9,
                 cfg_consts, interpret)


block_blend_cols.defvjp(_fwd, _bwd)
