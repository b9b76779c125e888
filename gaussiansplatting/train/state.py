"""Full training state pytree: parameters + Adam moments + density-control
accumulators + iteration counter + PRNG key.

The reference has no such object — state is scattered across Metal buffers
(optimizer.mm:34-60, density_control.mm:92-101) — but collecting it in one
pytree makes checkpoints complete (params + m/v + step + accumulators,
SURVEY.md §5 checkpoint row) and the train step a pure function.
"""

from __future__ import annotations

from gaussiansplatting.core import pytree
import jax
import jax.numpy as jnp

from gaussiansplatting.core.gaussians import GaussianParams
from gaussiansplatting.density.control import DensityAccum, init_accum
from gaussiansplatting.train.optimizer import AdamState, init_state


@pytree.dataclass
class TrainState:
    params: GaussianParams
    opt: AdamState
    accum: DensityAccum
    key: jax.Array

    @property
    def iteration(self) -> jnp.ndarray:
        """Completed optimizer steps (== Adam timestep, optimizer.mm:251)."""
        return self.opt.t


def create(params: GaussianParams, seed: int = 0) -> TrainState:
    return TrainState(
        params=params,
        opt=init_state(params),
        accum=init_accum(params.capacity),
        key=jax.random.PRNGKey(seed),
    )


def grow(state: TrainState, new_capacity: int) -> TrainState:
    """Re-pad every per-Gaussian array to ``new_capacity`` slots.

    The counterpart of the reference's buffer reallocation on densify
    (density_control.mm:385-490): shapes are static per compiled program,
    so growth re-pads the whole state pytree to the next capacity bucket
    (each bucket compiles once).  New slots are dead: alive=False, identity
    quaternions, zero Adam moments and accumulators.
    """
    from gaussiansplatting.core import gaussians as G

    old = state.params.capacity
    if new_capacity <= old:
        return state

    def pad(x):
        return jnp.pad(x, [(0, new_capacity - old)] + [(0, 0)] * (x.ndim - 1))

    p = state.params
    params = GaussianParams(
        means=pad(p.means),
        log_scales=pad(p.log_scales),
        quats=jnp.concatenate(
            [p.quats,
             jnp.zeros((new_capacity - old, 4), jnp.float32).at[:, 0].set(1.0)]
        ),
        raw_opacities=pad(p.raw_opacities),
        sh=pad(p.sh),
        alive=pad(p.alive),
    )
    opt = state.opt.replace(
        m={k: pad(v) for k, v in state.opt.m.items()},
        v={k: pad(v) for k, v in state.opt.v.items()},
    )
    accum = DensityAccum(
        grad_accum=pad(state.accum.grad_accum),
        grad_count=pad(state.accum.grad_count),
        pos_grad_accum=pad(state.accum.pos_grad_accum),
    )
    return state.replace(params=params, opt=opt, accum=accum)
