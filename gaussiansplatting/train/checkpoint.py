"""Full train-state checkpointing.

The reference can only export a PLY at the end of training (main.mm:408-418)
— no optimizer state, no resume.  Here a checkpoint is the COMPLETE TrainState
pytree (Gaussian params, Adam m/v/t, density accumulators, PRNG key) plus the
Config, so training resumes bit-exactly (SURVEY.md §5 checkpoint row).

Format: one .npz with flattened pytree leaves keyed by path, plus the config
JSON embedded — transparent, dependency-free, and loadable from any host.
"""

from __future__ import annotations

import io as _io
import json
import os

import jax
import numpy as np

from gaussiansplatting.config import Config
from gaussiansplatting.train.state import TrainState

FORMAT_VERSION = 1


def _leaf_key(path) -> str:
    parts = []
    for p in path:
        for attr in ("name", "key", "idx"):
            v = getattr(p, attr, None)
            if v is not None:
                parts.append(str(v))
                break
        else:
            parts.append(str(p))
    return "/".join(parts)


def save(path: str, state: TrainState, config: Config | None = None) -> None:
    """Atomically write the checkpoint (write temp, rename)."""
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(state)[0]
    arrays = {_leaf_key(p): np.asarray(v) for p, v in leaves_with_paths}
    meta = {
        "format_version": FORMAT_VERSION,
        "config": json.loads(config.to_json()) if config is not None else None,
        "iteration": int(np.asarray(state.opt.t)),
        "capacity": state.params.capacity,
    }
    buf = _io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load(path: str) -> tuple[TrainState, Config | None]:
    """Load a checkpoint; returns (state, config-or-None)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {meta['format_version']} newer than "
                f"supported {FORMAT_VERSION}"
            )
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    # Rebuild by structure-matching against a freshly-created template state
    # of the same capacity: leaf paths are deterministic, so each template
    # leaf maps to exactly one saved array.
    from gaussiansplatting.core import gaussians as gaussians_mod
    from gaussiansplatting.train import state as state_mod

    template = state_mod.create(gaussians_mod.zeros(int(meta["capacity"])))
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, _ in paths:
        key = _leaf_key(path)
        if key not in arrays:
            raise ValueError(f"checkpoint missing leaf {key!r}")
        leaves.append(arrays[key])
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    config = Config.from_json(json.dumps(meta["config"])) if meta["config"] else None
    return jax.device_put(state), config
