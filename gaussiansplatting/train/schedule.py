"""Learning-rate schedule (reference: exponentialLRDecay, mtl_engine.mm:1039-1045)."""

from __future__ import annotations

import jax.numpy as jnp

from gaussiansplatting.config import OptimConfig
from gaussiansplatting.train.optimizer import LearningRates


def exponential_lr_decay(lr_init, lr_final, current_iter, max_iter):
    """lr_init * (lr_final/lr_init)^(t/T), clamped to lr_final at t >= T."""
    t = jnp.asarray(current_iter, jnp.float32) / jnp.maximum(
        jnp.asarray(max_iter, jnp.float32), 1.0
    )
    lr = lr_init * jnp.power(lr_final / lr_init, t)
    return jnp.where(current_iter >= max_iter, lr_final, lr)


def learning_rates(
    cfg: OptimConfig, current_iter, total_iters
) -> LearningRates:
    """Only the position LR decays; the rest are constant
    (mtl_engine.mm:1059-1068, 1092-1094)."""
    return LearningRates(
        position=exponential_lr_decay(
            cfg.position_lr_init, cfg.position_lr_final, current_iter, total_iters
        ),
        scale=jnp.float32(cfg.scale_lr),
        rotation=jnp.float32(cfg.rotation_lr),
        opacity=jnp.float32(cfg.opacity_lr),
        sh=jnp.float32(cfg.sh_lr),
    )
