"""Adam optimizer semantics vs a NumPy oracle of the adamStep kernel
(shaders.metal:536-713)."""

import numpy as np
import jax
import jax.numpy as jnp

from gaussiansplatting.config import OptimConfig
from gaussiansplatting.core import gaussians as G
from gaussiansplatting.train import optimizer
from gaussiansplatting.train.optimizer import LearningRates


def _mk_params(rng, n=8):
    means = rng.normal(size=(n, 3)).astype(np.float32)
    return G.from_arrays(
        means,
        rng.uniform(-2, 0, (n, 3)).astype(np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        rng.uniform(-1, 1, (n,)).astype(np.float32),
        rng.uniform(-1, 1, (n, 4, 3)).astype(np.float32),
    )


def _mk_grads(rng, params, scale=1.0):
    return {
        f: jnp.asarray(
            (rng.normal(size=getattr(params, f).shape) * scale).astype(np.float32)
        )
        for f in optimizer.TRAINABLE
    }


def _lrs():
    return LearningRates(
        position=jnp.float32(0.1),
        scale=jnp.float32(0.05),
        rotation=jnp.float32(0.01),
        opacity=jnp.float32(0.025),
        sh=jnp.float32(0.0025),
    )


def test_adam_first_step_closed_form(rng):
    """After one step from zero state: m_hat = g, v_hat = g^2,
    update = lr * g/(|g|+eps) = lr * sign(g)."""
    params = _mk_params(rng)
    state = optimizer.init_state(params)
    cfg = OptimConfig()
    grads = _mk_grads(rng, params, scale=0.1)  # below clip
    new_params, new_state = jax.jit(optimizer.step, static_argnums=4)(
        params, grads, state, _lrs(), cfg
    )
    assert int(new_state.t) == 1
    g = np.asarray(grads["raw_opacities"])
    expected = np.asarray(params.raw_opacities) - 0.025 * g / (np.abs(g) + cfg.eps)
    np.testing.assert_allclose(
        np.asarray(new_params.raw_opacities), np.clip(expected, -8, 8), rtol=1e-5
    )


def test_gradient_clip(rng):
    """Elements are clipped to +/-0.5 before moment updates (shaders.metal:585)."""
    params = _mk_params(rng)
    state = optimizer.init_state(params)
    cfg = OptimConfig()
    big = {f: jnp.full_like(getattr(params, f), 100.0) for f in optimizer.TRAINABLE}
    _, new_state = optimizer.step(params, big, state, _lrs(), cfg)
    np.testing.assert_allclose(
        np.asarray(new_state.m["raw_opacities"]), (1 - cfg.beta1) * 0.5, rtol=1e-6
    )


def test_position_update_norm_clamp(rng):
    """Position update vector norm is limited to 0.1 (shaders.metal:615-618)."""
    params = _mk_params(rng)
    state = optimizer.init_state(params)
    grads = _mk_grads(rng, params, scale=10.0)
    new_params, _ = optimizer.step(
        params, grads, state, _lrs()._replace(position=jnp.float32(10.0)), OptimConfig()
    )
    delta = np.asarray(new_params.means) - np.asarray(params.means)
    norms = np.linalg.norm(delta[np.asarray(params.alive)], axis=-1)
    assert np.all(norms <= 0.1 + 1e-5)


def test_param_clamps(rng):
    params = _mk_params(rng)
    state = optimizer.init_state(params)
    lrs = LearningRates(*(jnp.float32(100.0) for _ in range(5)))
    grads = _mk_grads(rng, params, scale=1.0)
    new_params, _ = optimizer.step(params, grads, state, lrs, OptimConfig())
    alive = np.asarray(params.alive)
    assert np.all(np.abs(np.asarray(new_params.log_scales)[alive]) <= 4.0 + 1e-5)
    assert np.all(np.abs(np.asarray(new_params.raw_opacities)[alive]) <= 8.0 + 1e-5)
    assert np.all(np.abs(np.asarray(new_params.sh)[alive]) <= 2.0 + 1e-5)
    qn = np.linalg.norm(np.asarray(new_params.quats)[alive], axis=-1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-5)  # renormalized


def test_nan_gradient_skips_gaussian(rng):
    params = _mk_params(rng)
    state = optimizer.init_state(params)
    grads = _mk_grads(rng, params, scale=0.1)
    grads["means"] = grads["means"].at[2, 0].set(jnp.nan)
    new_params, new_state = optimizer.step(params, grads, state, _lrs(), OptimConfig())
    # gaussian 2 fully frozen (params and moments)
    np.testing.assert_allclose(np.asarray(new_params.means[2]), np.asarray(params.means[2]))
    np.testing.assert_allclose(np.asarray(new_params.sh[2]), np.asarray(params.sh[2]))
    np.testing.assert_allclose(np.asarray(new_state.m["sh"][2]), 0.0)
    # others updated
    assert not np.allclose(np.asarray(new_params.means[0]), np.asarray(params.means[0]))


def test_dead_gaussians_frozen(rng):
    params = _mk_params(rng)
    params = params.replace(alive=params.alive.at[5:].set(False))
    state = optimizer.init_state(params)
    grads = _mk_grads(rng, params, scale=0.1)
    new_params, new_state = optimizer.step(params, grads, state, _lrs(), OptimConfig())
    np.testing.assert_allclose(
        np.asarray(new_params.means[5:]), np.asarray(params.means[5:])
    )
    np.testing.assert_allclose(np.asarray(new_state.m["means"][5:]), 0.0)


def test_momentum_reset():
    params = _mk_params(np.random.default_rng(0))
    state = optimizer.init_state(params)
    state = state.replace(
        m={k: v + 1.0 for k, v in state.m.items()},
        v={k: v + 2.0 for k, v in state.v.items()},
    )
    out = optimizer.reset_opacity_and_scale_momentum(state)
    np.testing.assert_allclose(np.asarray(out.m["raw_opacities"]), 0.0)
    np.testing.assert_allclose(np.asarray(out.v["log_scales"]), 0.0)
    np.testing.assert_allclose(np.asarray(out.m["means"]), 1.0)  # untouched
