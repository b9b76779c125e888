"""Gaussian parameter pytree: padded fixed-capacity arrays with an alive mask.

The reference stores Gaussians in a dynamically reallocated Metal buffer
(struct Gaussian, tiled_shaders.metal:11-22) and swaps buffers on densify
(density_control.mm:385-490).  Compiled programs need static shapes, so
parameters live in [capacity, ...] arrays with ``alive`` marking the first
``count`` live rows (densification compacts in place; see density/control.py).

SH layout: [capacity, 4, 3] = (coefficient, channel) with coeff 0 the DC term.
The reference flattens per-channel groups of 4 (sh[0..3]=R, sh[4..7]=G,
sh[8..11]=B, ply_loader.hpp:14-20); io/ply.py converts at the boundary.
"""

from __future__ import annotations

from gaussiansplatting.core import pytree
import jax.numpy as jnp
import numpy as np


@pytree.dataclass
class GaussianParams:
    means: jnp.ndarray          # [C, 3]  world positions
    log_scales: jnp.ndarray     # [C, 3]  log-space scales
    quats: jnp.ndarray          # [C, 4]  (w, x, y, z), not necessarily normalized
    raw_opacities: jnp.ndarray  # [C]     pre-sigmoid opacity
    sh: jnp.ndarray             # [C, 4, 3] SH coeffs, [:,0,:] = DC
    alive: jnp.ndarray          # [C]     bool mask of live Gaussians

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def count(self) -> jnp.ndarray:
        """Number of live Gaussians (traced value)."""
        return jnp.sum(self.alive.astype(jnp.int32))

    @property
    def sh_dc(self) -> jnp.ndarray:
        return self.sh[:, 0, :]


def zeros(capacity: int) -> GaussianParams:
    return GaussianParams(
        means=jnp.zeros((capacity, 3), jnp.float32),
        log_scales=jnp.zeros((capacity, 3), jnp.float32),
        quats=jnp.zeros((capacity, 4), jnp.float32).at[:, 0].set(1.0),
        raw_opacities=jnp.zeros((capacity,), jnp.float32),
        sh=jnp.zeros((capacity, 4, 3), jnp.float32),
        alive=jnp.zeros((capacity,), bool),
    )


def from_arrays(
    means: np.ndarray,
    log_scales: np.ndarray,
    quats: np.ndarray,
    raw_opacities: np.ndarray,
    sh: np.ndarray,
    capacity: int | None = None,
) -> GaussianParams:
    """Pack host arrays into a padded GaussianParams.

    ``sh`` may be [N, 4, 3] or the reference's flat [N, 12] channel-major
    layout (R0..R3, G0..G3, B0..B3)."""
    n = means.shape[0]
    cap = int(capacity if capacity is not None else n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    sh = np.asarray(sh, np.float32)
    if sh.ndim == 2 and sh.shape[1] == 12:
        sh = sh.reshape(n, 3, 4).transpose(0, 2, 1)  # [N,3ch,4coef] -> [N,4,3]
    out = zeros(cap)
    sl = slice(0, n)
    return out.replace(
        means=out.means.at[sl].set(jnp.asarray(means, jnp.float32)),
        log_scales=out.log_scales.at[sl].set(jnp.asarray(log_scales, jnp.float32)),
        quats=out.quats.at[sl].set(jnp.asarray(quats, jnp.float32)),
        raw_opacities=out.raw_opacities.at[sl].set(
            jnp.asarray(raw_opacities, jnp.float32)
        ),
        sh=out.sh.at[sl].set(jnp.asarray(sh, jnp.float32)),
        alive=out.alive.at[sl].set(True),
    )


def to_flat_sh(sh: np.ndarray) -> np.ndarray:
    """[N, 4, 3] -> the reference's flat [N, 12] (R0..R3, G0..G3, B0..B3)."""
    return np.asarray(sh).transpose(0, 2, 1).reshape(sh.shape[0], 12)
