"""Differentiable SSIM / D-SSIM via separable depthwise convolution.

Matches the reference's per-pixel SSIM kernel (shaders.metal:380-483):
11x11 window, sigma=1.5 Gaussian weights computed from exp(-d^2/2s^2) and
normalized over the full window, grayscale = mean(RGB), replicate boundary
sampling, C1=0.01^2, C2=0.03^2, D-SSIM = clamp((1-SSIM)/2, 0, 1).

The reference evaluates this two-pass per pixel; here it is three separable
Gaussian blurs (x, x^2, xy), which is algebraically identical:
sigma_x^2 = E[x^2] - E[x]^2 under the same normalized window.

Unlike the reference — which computes D-SSIM for the *scalar* loss only and
never differentiates it (tiled_shaders.metal:417-423) — this implementation is
fully differentiable, so the combined loss can drive training.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=8)
def _gauss_kernel_1d_np(window: int, sigma: float):
    # cached as numpy: a cached jnp array would leak tracers across jit traces
    import numpy as np

    r = window // 2
    d = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-(d * d) / (2.0 * sigma * sigma))
    # The reference normalizes by the sum of the full 2D window
    # (shaders.metal:430-436); a separable 1D kernel normalized to 1 in each
    # pass gives the identical 2D normalization.
    return (w / w.sum()).astype(np.float32)


def _gauss_kernel_1d(window: int, sigma: float):
    return jnp.asarray(_gauss_kernel_1d_np(window, sigma))


@functools.lru_cache(maxsize=16)
def _band_matrix_np(size: int, window: int, sigma: float):
    """[size, size] band matrix B with replicate-edge semantics:
    (x @ B)[j] = sum_d k[d] * x[clip(j + d - r, 0, size-1)]."""
    import numpy as np

    k = _gauss_kernel_1d_np(window, sigma)
    r = window // 2
    b = np.zeros((size, size), np.float32)
    for d in range(window):
        src = np.clip(np.arange(size) + d - r, 0, size - 1)
        np.add.at(b, (src, np.arange(size)), k[d])
    return b


def _blur_many(imgs: jnp.ndarray, window: int, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur of K stacked [K, H, W] planes with replicate
    padding, as two BAND-MATRIX MATMULS ([K*H, W] @ [W, W] and
    [H, H]^T @ ...) instead of a single-channel convolution.  HIGHEST
    precision keeps the products in f32 (no TF32)."""
    kk, h, w = imgs.shape
    bw = jnp.asarray(_band_matrix_np(w, window, sigma))
    bh = jnp.asarray(_band_matrix_np(h, window, sigma))
    x = jnp.einsum(
        "khw,wv->khv", imgs, bw, precision=jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "khv,hu->kuv", x, bh, precision=jax.lax.Precision.HIGHEST
    )


def _blur(img: jnp.ndarray, window: int, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur of a [H, W] image with replicate padding."""
    return _blur_many(img[None], window, sigma)[0]


def dssim_map(
    rendered: jnp.ndarray,
    ground_truth: jnp.ndarray,
    window: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01 ** 2,
    c2: float = 0.03 ** 2,
) -> jnp.ndarray:
    """Per-pixel D-SSIM map [H, W] from [H, W, 3] images in [0, 1]."""
    x = jnp.mean(rendered, axis=-1)      # grayscale mean-RGB (shaders.metal:443)
    y = jnp.mean(ground_truth, axis=-1)

    mu_x, mu_y, e_xx, e_yy, e_xy = _blur_many(
        jnp.stack([x, y, x * x, y * y, x * y]), window, sigma
    )

    var_x = e_xx - mu_x * mu_x
    var_y = e_yy - mu_y * mu_y
    cov_xy = e_xy - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + c1) * (2.0 * cov_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2)
    ssim = num / den
    return jnp.clip((1.0 - ssim) / 2.0, 0.0, 1.0)
