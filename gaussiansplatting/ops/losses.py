"""Photometric training loss.

The reference computes a scalar (1-lambda)*L1 + lambda*D-SSIM for logging
(shaders.metal:487-511) but backpropagates ONLY dL/dpixel = sign(diff)/3 — the
gradient of the UNWEIGHTED PER-PIXEL-SUMMED L1 (tiled_shaders.metal:417-423).
Two consequences encoded here:

  * the gradient-carrying loss is a SUM over pixels, not a mean (the Adam
    clips at +/-0.5 are tuned against that magnitude);
  * ``dssim_in_grad`` selects between strict reference-gradient parity
    (L1-sum only) and the improved fully differentiable combined loss.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gaussiansplatting.config import LossConfig
from gaussiansplatting.ops.ssim import dssim_map


class LossReport(NamedTuple):
    grad_loss: jnp.ndarray       # the scalar that was differentiated
    combined_mean: jnp.ndarray   # (1-l)*L1 + l*DSSIM, per-pixel mean (logged)
    l1_mean: jnp.ndarray
    dssim_mean: jnp.ndarray


def l1_per_pixel(rendered: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    """Mean-over-RGB absolute error per pixel (shaders.metal:320-340)."""
    return jnp.mean(jnp.abs(rendered - gt), axis=-1)


def photometric_loss(
    rendered: jnp.ndarray, gt: jnp.ndarray, cfg: LossConfig
) -> LossReport:
    l1 = l1_per_pixel(rendered, gt)
    dssim = dssim_map(
        rendered, gt, cfg.ssim_window, cfg.ssim_sigma, cfg.ssim_c1, cfg.ssim_c2
    )
    lam = cfg.lambda_dssim
    if cfg.dssim_in_grad:
        grad_loss = (1.0 - lam) * jnp.sum(l1) + lam * jnp.sum(dssim)
    else:
        # strict parity: gradient of sum(L1) only, D-SSIM observed but inert
        grad_loss = jnp.sum(l1) + 0.0 * jax.lax.stop_gradient(jnp.sum(dssim))
    l1_mean = jnp.mean(l1)
    dssim_mean = jnp.mean(dssim)
    return LossReport(
        grad_loss=grad_loss,
        combined_mean=(1.0 - lam) * l1_mean + lam * dssim_mean,
        l1_mean=l1_mean,
        dssim_mean=dssim_mean,
    )


def psnr(rendered: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    mse = jnp.mean((rendered - gt) ** 2)
    return -10.0 * jnp.log10(jnp.maximum(mse, 1e-12))
