"""Device mesh helpers.

The reference is single-process/single-GPU with no communication backend
(SURVEY.md §2.3).  This framework scales by sharding image TILES across
devices on a 1-D mesh, with Gaussian parameters replicated and their
gradients all-reduced by collectives — the 3DGS analog of data/sequence
parallelism.  The cards of one host reach each other all to all (NVLink),
so the mesh follows the algorithm alone.  Several hosts initialize via
jax.distributed and reuse the same mesh."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


TILE_AXIS = "tiles"


def make_mesh(num_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (TILE_AXIS,))


def initialize_distributed(coordinator: str | None = None, **kwargs) -> None:
    """Multi-host initialization (jax.distributed); no-op for single process."""
    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator, **kwargs)
