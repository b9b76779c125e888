"""Adam optimizer with the reference's exact clip/clamp set — one jitted,
fully vectorized update (the reference's per-thread adamStep kernel,
shaders.metal:536-713, driven by optimizer.mm:241-296).

Per-field semantics reproduced:
  * all gradients element-clipped to +/-0.5 before the moment update;
  * positions: update-vector norm limited to 0.1, result sanity-checked
    (finite, |x| < 1e6) or the position is left unchanged;
  * log-scales: result clamped to +/-4 (MAX_SCALE_TRAIN, shaders.metal:55);
  * rotations: renormalized after the step (identity fallback);
  * raw opacity: clamped to +/-8;
  * SH: clamped to +/-2;
  * a Gaussian is skipped entirely when its position/opacity/sh gradients are
    NaN/Inf or its position is corrupt (shaders.metal:567-576);
  * dead (padding) Gaussians are frozen so their m/v stay zero.
"""

from __future__ import annotations

from typing import NamedTuple

from gaussiansplatting.core import pytree
import jax.numpy as jnp

from gaussiansplatting.config import OptimConfig
from gaussiansplatting.core.gaussians import GaussianParams


@pytree.dataclass
class AdamState:
    m: dict   # field name -> first-moment array, same shapes as params
    v: dict   # field name -> second-moment array
    t: jnp.ndarray  # [] int32 timestep (incremented per step, optimizer.mm:251)


TRAINABLE = ("means", "log_scales", "quats", "raw_opacities", "sh")


def init_state(params: GaussianParams) -> AdamState:
    zeros = {f: jnp.zeros_like(getattr(params, f)) for f in TRAINABLE}
    return AdamState(
        m=zeros,
        v={f: jnp.zeros_like(getattr(params, f)) for f in TRAINABLE},
        t=jnp.int32(0),
    )


class LearningRates(NamedTuple):
    position: jnp.ndarray
    scale: jnp.ndarray
    rotation: jnp.ndarray
    opacity: jnp.ndarray
    sh: jnp.ndarray


def _bc(beta: float, t: jnp.ndarray) -> jnp.ndarray:
    return 1.0 - jnp.power(beta, t.astype(jnp.float32))


def step(
    params: GaussianParams,
    grads: dict,
    state: AdamState,
    lrs: LearningRates,
    cfg: OptimConfig,
) -> tuple[GaussianParams, AdamState]:
    t = state.t + 1
    bc1 = _bc(cfg.beta1, t)
    bc2 = _bc(cfg.beta2, t)

    # per-Gaussian skip mask (shaders.metal:567-576): invalid grads or corrupt
    # position freeze the whole Gaussian for this step.
    def _finite(x, axes):
        return jnp.all(jnp.isfinite(x), axis=axes) if axes else jnp.isfinite(x)

    bad = (
        ~_finite(grads["means"], (-1,))
        | ~jnp.isfinite(grads["raw_opacities"])
        | ~_finite(grads["sh"], (-1, -2))
        | ~_finite(params.means, (-1,))
        | jnp.any(jnp.abs(params.means) > 1e6, axis=-1)
    )
    active = params.alive & ~bad  # [C]

    def moments(field, grad):
        g = jnp.clip(grad, -cfg.grad_clip, cfg.grad_clip)
        m = cfg.beta1 * state.m[field] + (1.0 - cfg.beta1) * g
        v = cfg.beta2 * state.v[field] + (1.0 - cfg.beta2) * g * g
        update_dir = (m / bc1) / (jnp.sqrt(v / bc2) + cfg.eps)
        return m, v, update_dir

    new_m, new_v, new_params = {}, {}, {}

    def mask(x):
        return active.reshape(active.shape + (1,) * (x.ndim - 1))

    # --- positions
    m, v, d = moments("means", grads["means"])
    upd = lrs.position * d
    norm = jnp.linalg.norm(upd, axis=-1, keepdims=True)
    upd = upd * jnp.where(
        norm > cfg.position_update_norm_clip,
        cfg.position_update_norm_clip / jnp.maximum(norm, 1e-20),
        1.0,
    )
    new_pos = params.means - upd
    pos_ok = jnp.all(jnp.isfinite(new_pos), axis=-1, keepdims=True) & (
        jnp.max(jnp.abs(new_pos), axis=-1, keepdims=True) < 1e6
    )
    new_params["means"] = jnp.where(mask(new_pos) & pos_ok, new_pos, params.means)
    new_m["means"], new_v["means"] = m, v

    # --- log scales
    m, v, d = moments("log_scales", grads["log_scales"])
    new_scale = jnp.clip(
        params.log_scales - lrs.scale * d, -cfg.log_scale_clamp, cfg.log_scale_clamp
    )
    new_params["log_scales"] = jnp.where(mask(new_scale), new_scale, params.log_scales)
    new_m["log_scales"], new_v["log_scales"] = m, v

    # --- rotations (renormalize, identity fallback; shaders.metal:676-681)
    m, v, d = moments("quats", grads["quats"])
    new_q = params.quats - lrs.rotation * d
    qn = jnp.linalg.norm(new_q, axis=-1, keepdims=True)
    identity = jnp.zeros_like(new_q).at[:, 0].set(1.0)
    new_q = jnp.where(qn > 1e-3, new_q / jnp.maximum(qn, 1e-3), identity)
    new_params["quats"] = jnp.where(mask(new_q), new_q, params.quats)
    new_m["quats"], new_v["quats"] = m, v

    # --- raw opacity
    m, v, d = moments("raw_opacities", grads["raw_opacities"])
    new_op = jnp.clip(
        params.raw_opacities - lrs.opacity * d,
        -cfg.raw_opacity_clamp,
        cfg.raw_opacity_clamp,
    )
    new_params["raw_opacities"] = jnp.where(active, new_op, params.raw_opacities)
    new_m["raw_opacities"], new_v["raw_opacities"] = m, v

    # --- SH
    m, v, d = moments("sh", grads["sh"])
    new_sh = jnp.clip(params.sh - lrs.sh * d, -cfg.sh_clamp, cfg.sh_clamp)
    new_params["sh"] = jnp.where(mask(new_sh), new_sh, params.sh)
    new_m["sh"], new_v["sh"] = m, v

    # freeze moments of inactive Gaussians (keeps padding state exactly zero)
    for f in TRAINABLE:
        new_m[f] = jnp.where(mask(new_m[f]), new_m[f], state.m[f])
        new_v[f] = jnp.where(mask(new_v[f]), new_v[f], state.v[f])

    return (
        params.replace(**new_params),
        AdamState(m=new_m, v=new_v, t=t),
    )


def reset_opacity_and_scale_momentum(state: AdamState) -> AdamState:
    """Zero opacity and scale m/v at opacity resets
    (optimizer.mm:137-147, called from mtl_engine.mm:1188-1189)."""
    m = dict(state.m)
    v = dict(state.v)
    for f in ("raw_opacities", "log_scales"):
        m[f] = jnp.zeros_like(m[f])
        v[f] = jnp.zeros_like(v[f])
    return state.replace(m=m, v=v)
