"""Loss pipeline tests: SSIM vs a literal per-pixel oracle of the reference
kernel (shaders.metal:380-483), L1, combined loss, gradient modes."""

import numpy as np
import jax
import jax.numpy as jnp

from gaussiansplatting.config import LossConfig
from gaussiansplatting.ops.losses import l1_per_pixel, photometric_loss, psnr
from gaussiansplatting.ops.ssim import dssim_map


def _ssim_oracle(x, y, window=11, sigma=1.5, c1=0.01**2, c2=0.03**2):
    """Direct per-pixel two-pass implementation of computeSSIM
    (shaders.metal:400-483) in float64."""
    h, w = x.shape
    r = window // 2
    out = np.zeros((h, w))
    for py in range(h):
        for px in range(w):
            mu_x = mu_y = wsum = 0.0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    sx = min(max(px + dx, 0), w - 1)
                    sy = min(max(py + dy, 0), h - 1)
                    wgt = np.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
                    wsum += wgt
                    mu_x += wgt * x[sy, sx]
                    mu_y += wgt * y[sy, sx]
            mu_x /= wsum
            mu_y /= wsum
            vx = vy = cxy = wsum2 = 0.0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    sx = min(max(px + dx, 0), w - 1)
                    sy = min(max(py + dy, 0), h - 1)
                    wgt = np.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
                    wsum2 += wgt
                    vx += wgt * (x[sy, sx] - mu_x) ** 2
                    vy += wgt * (y[sy, sx] - mu_y) ** 2
                    cxy += wgt * (x[sy, sx] - mu_x) * (y[sy, sx] - mu_y)
            vx /= wsum2
            vy /= wsum2
            cxy /= wsum2
            num = (2 * mu_x * mu_y + c1) * (2 * cxy + c2)
            den = (mu_x**2 + mu_y**2 + c1) * (vx + vy + c2)
            out[py, px] = np.clip((1 - num / den) / 2, 0, 1)
    return out


def test_dssim_matches_oracle_interior_and_edges(rng):
    h, w = 20, 24
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, (h, w, 3)), 0, 1).astype(np.float32)
    ours = np.asarray(dssim_map(jnp.asarray(a), jnp.asarray(b)))
    ref = _ssim_oracle(a.mean(-1).astype(np.float64), b.mean(-1).astype(np.float64))
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_dssim_identical_images_zero(rng):
    a = jnp.asarray(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    d = np.asarray(dssim_map(a, a))
    np.testing.assert_allclose(d, 0.0, atol=1e-5)


def test_l1_per_pixel():
    a = jnp.array([[[0.0, 0.5, 1.0]]])
    b = jnp.array([[[0.5, 0.5, 0.5]]])
    np.testing.assert_allclose(
        float(l1_per_pixel(a, b)[0, 0]), (0.5 + 0.0 + 0.5) / 3.0
    )


def test_photometric_loss_modes(rng):
    a = jnp.asarray(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    b = jnp.asarray(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))

    rep = photometric_loss(a, b, LossConfig())
    np.testing.assert_allclose(
        float(rep.combined_mean),
        0.8 * float(rep.l1_mean) + 0.2 * float(rep.dssim_mean),
        rtol=1e-6,
    )

    # parity mode: gradient is exactly d(sum L1)/dpixel = sign/3
    cfg = LossConfig(dssim_in_grad=False)
    g = jax.grad(lambda x: photometric_loss(x, b, cfg).grad_loss)(a)
    expected = np.sign(np.asarray(a) - np.asarray(b)) / 3.0
    np.testing.assert_allclose(np.asarray(g), expected, atol=1e-6)

    # combined mode: dssim contributes to the gradient
    cfg2 = LossConfig(dssim_in_grad=True)
    g2 = jax.grad(lambda x: photometric_loss(x, b, cfg2).grad_loss)(a)
    assert not np.allclose(np.asarray(g2), 0.8 * expected, atol=1e-6)


def test_psnr():
    a = jnp.zeros((8, 8, 3))
    b = jnp.full((8, 8, 3), 0.1)
    np.testing.assert_allclose(float(psnr(a, b)), -10 * np.log10(0.01), rtol=1e-3)
