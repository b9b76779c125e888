"""Speed-of-light model for one train step.

Answers "how far is the measured step from what the card allows?" with two
ingredients:

  * a SINGLE-TOUCH byte count: every array each pipeline stage must read
    or write at least once, at the STATIC shapes actually dispatched
    (index ops process full static rows regardless of live occupancy), for
    the block-aligned pair layout and the fused blend kernels.  Real sorts
    are multi-pass, so achieved bandwidth computed from it UNDERSTATES the
    truth by the pass count of the sort fraction;
  * an f32 FLOP count of the per-pixel blend arithmetic (forward and
    replayed backward) and the D-SSIM band matmuls; everything else is
    bandwidth.

The floor is max(bytes / HBM bandwidth, flops / f32 peak).  ``PEAKS`` holds
the published rates per ``jax.Device.device_kind``; a device that is not in
it is an error, never a default.
"""

from __future__ import annotations

# NVIDIA H100 data sheet (SXM5 80 GB part; dense rates, no sparsity):
# 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores, 989 TFLOP/s bf16
# tensor.  Rates assume the full 700 W power limit.
_H100_SXM = {
    "hbm_gbps": 3350.0,
    "f32_tflops": 67.0,
    "bf16_tflops": 989.0,
    "source": "NVIDIA H100 data sheet, SXM5 80 GB, dense",
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}

F32 = 4
# f32 operations per (pair, pixel) of the fused blend: the 6-term power
# (11), exp/alpha/masks (~8), the front-to-back update (~9) forward; the
# backward replays that and adds the transmittance gradient, ten
# per-Gaussian reductions and the chain rule (~45)
BLEND_FWD_FLOPS = 28
BLEND_BWD_FLOPS = 28 + 45


def peaks(device_kind: str) -> dict:
    """Published peak rates of ``device_kind``; KeyError if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates recorded for device kind {device_kind!r}; add "
            "its data-sheet numbers to utils/sol.PEAKS"
        ) from None


def step_model(
    n: int,
    pair_capacity: int,
    height: int,
    width: int,
    device_kind: str,
    tile_size: int = 16,
    block: int = 128,
    chunk_slack: float = 1.0,
) -> dict:
    """Single-touch bytes + f32 flops for one fwd+bwd+Adam step at the
    given STATIC shapes, and the floor on ``device_kind``.  Returns a dict
    with per-stage bytes, totals, and the floor in ms."""
    from gaussiansplatting.ops import pairs as pairs_mod

    peak = peaks(device_kind)
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    tiles = tiles_x * tiles_y
    p2 = tile_size * tile_size
    e_cap = (
        pairs_mod._chunk_capacity(pair_capacity, n, chunk_slack)
        * pairs_mod.PAIR_CHUNK
    )
    a_cap = pairs_mod.aligned_capacity(pair_capacity, tiles, block)
    nb = a_cap // block
    d = 9                                  # per-pair render data columns
    npix = height * width

    b = {}
    # chunk gather reads the [N, 6+D] table once, expansion writes
    # (tile, depth, gid, data) rows
    b["expand"] = n * (6 + d) * F32 + e_cap * (3 + d) * F32
    # (tile, depth) sort and the alignment sort: read + write all operands
    b["pair_sort"] = 2 * e_cap * (3 + d) * F32
    b["align_sort"] = 2 * (e_cap + tiles * block) * (2 + d) * F32
    # fused blend: nine [NB, B] columns in, [NB, 4, P2] out; the backward
    # reads the columns, the forward output and its cotangent, writes nine
    # column cotangents
    b["blend_fwd"] = a_cap * d * F32 + nb * 4 * p2 * F32
    b["blend_bwd"] = 2 * a_cap * d * F32 + 2 * nb * 4 * p2 * F32
    # by-Gaussian reduction sort + prefix sums + endpoint gathers
    b["grad_reduce"] = 2 * a_cap * (1 + d) * F32 + 2 * a_cap * d * F32 \
        + 2 * n * d * F32
    # compose tiles -> image, L1 + D-SSIM band matmuls (~12 image touches)
    b["image_loss"] = nb * 4 * p2 * F32 + 12 * npix * 3 * F32
    # projection fwd+bwd (~40 f32 fields per Gaussian each way)
    b["projection"] = 2 * 40 * n * F32
    # Adam: 23 trainable floats per Gaussian; read p/m/v/g, write p/m/v
    b["optimizer"] = 7 * 23 * n * F32
    bytes_total = float(sum(b.values()))

    blend = a_cap * p2 * (BLEND_FWD_FLOPS + BLEND_BWD_FLOPS)
    ssim = 4 * 2 * 11 * npix * 3 * 2      # 4 blurs x 2 band matmuls x 11-wide
    flops_total = float(blend + ssim)

    t_bytes_ms = bytes_total / (peak["hbm_gbps"] * 1e9) * 1e3
    t_flops_ms = flops_total / (peak["f32_tflops"] * 1e12) * 1e3
    return {
        "bytes_by_stage": b,
        "bytes_total": bytes_total,
        "f32_flops": flops_total,
        "t_bytes_ms": t_bytes_ms,
        "t_flops_ms": t_flops_ms,
        "floor_ms": max(t_bytes_ms, t_flops_ms),
        "peak_source": peak["source"],
    }
