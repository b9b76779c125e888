"""Stage-timing CLI: prints per-stage ms for the full train step on a
synthetic scene (the counterpart of the reference's per-stage printout,
tiled_rasterizer.mm:639-671).

  python -m gaussiansplatting.tools.profile [--n 100000] [--width 800]
      [--height 608] [--pair-capacity 2097152]
"""

from __future__ import annotations

import argparse
import json


def stage_times(
    n: int = 100_000,
    width: int = 800,
    height: int = 608,
    pair_capacity: int = 1 << 21,
    pair_block: int = 128,
    names=("project", "project_pairs", "forward", "forward_loss",
           "forward_backward", "train_step"),
    emit=None,
) -> dict:
    """Measure cumulative per-stage ms on a synthetic scene; returns
    {stage: ms}.  Each stage costs one (possibly minutes-long) compile."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.ops import pairs as pairs_mod
    from gaussiansplatting.ops import projection as proj_mod
    from gaussiansplatting.ops.losses import photometric_loss
    from gaussiansplatting.ops.rasterize import render
    from gaussiansplatting.train import state as state_mod
    from gaussiansplatting.train.trainer import train_step
    from gaussiansplatting.utils import synthetic
    from gaussiansplatting.utils.profiling import loop_time_ms

    cfg = Config(
        raster=RasterConfig(
            pair_capacity=pair_capacity, pair_block=pair_block
        )
    )
    rc = cfg.raster
    params = synthetic.make_scene(n=n, seed=0)
    cam = synthetic.make_canonical_camera(width, height)
    gt = jnp.asarray(
        np.random.default_rng(1).uniform(0, 1, (height, width, 3)),
        jnp.float32,
    )
    tiles_x = proj_mod.num_tiles(width, rc.tile_size)
    tiles_y = proj_mod.num_tiles(height, rc.tile_size)

    # Every staged fn maps means->means so it can loop; the stage output is
    # folded back into the carry to keep the whole loop body live.
    def fold(x):
        return jnp.sum(x).astype(jnp.float32) * 1e-20

    def st_project(means):
        pr = proj_mod.project(params.replace(means=means), cam, rc)
        return means + fold(pr.screen_pos)

    def st_pairs(means):
        pr = proj_mod.project(params.replace(means=means), cam, rc)
        pb = pairs_mod.build_pairs(pr, tiles_x, tiles_y, rc.pair_capacity, rc.pair_block)
        return means + fold(pb.gaussian_id.astype(jnp.float32))

    def st_render(means):
        img, _ = render(params.replace(means=means), cam, rc)
        return means + fold(img)

    # -- fine-grained sub-stages of the blend section (profiling-only
    #    duplication of render's internals) --
    def _pair_cols(means):
        p = params.replace(means=means)
        pr = proj_mod.project(p, cam, rc)
        data = jnp.concatenate(
            [pr.screen_pos, pr.conic, pr.opacity[:, None], pr.color], axis=-1
        )
        return pairs_mod.build_pair_rows(
            pr, data, tiles_x, tiles_y, rc.pair_capacity, rc.pair_block
        )

    def _blend_inputs(means):
        pb = _pair_cols(means)
        nb = pb.gaussian_id.shape[0] // rc.pair_block
        cols = [pb.rows[i].reshape(nb, rc.pair_block) for i in range(9)]
        gid = pb.gaussian_id.reshape(nb, rc.pair_block)
        conic_mag = jnp.abs(cols[2]) + jnp.abs(cols[3]) + jnp.abs(cols[4])
        op_eff = jnp.where((gid >= 0) & (conic_mag >= 1e-4), cols[5], 0.0)
        return pb, cols, op_eff

    def st_blend_inputs(means):
        _, cols, op_eff = _blend_inputs(means)
        return means + fold(op_eff) + sum(fold(c) for c in cols[:5])

    def st_blend_fwd(means):
        from gaussiansplatting.ops.pallas_blend import block_blend_cols

        _, cols, op_eff = _blend_inputs(means)
        out = block_blend_cols(
            cols[0], cols[1], cols[2], cols[3], cols[4], op_eff,
            cols[6], cols[7], cols[8],
            (rc.tile_size, rc.power_floor, rc.alpha_cap, rc.alpha_floor),
        )
        return means + fold(out)

    def st_blend_kernel_bwd(means):
        # cumulative [pairs fwd + kernel fwd + kernel BWD]: cotangents stop
        # at the columns, so vs blend_fwd the delta is the bwd kernel alone
        from gaussiansplatting.ops.pallas_blend import block_blend_cols

        _, cols, op_eff = _blend_inputs(means)
        args = (cols[0], cols[1], cols[2], cols[3], cols[4], op_eff,
                cols[6], cols[7], cols[8])

        def f(*cs):
            out = block_blend_cols(
                *cs,
                (rc.tile_size, rc.power_floor, rc.alpha_cap, rc.alpha_floor),
            )
            return jnp.sum(out)

        gs = jax.grad(f, argnums=tuple(range(9)))(*args)
        return means + sum(fold(g) for g in gs)

    def st_pairs_bwd(means):
        # cumulative [pairs fwd + pairs BWD]: vs blend_inputs the delta is
        # the pair-pipeline custom VJP (sortprefix reduction).  The weight
        # makes the cotangent position-dependent — a uniform-ones cotangent
        # lets XLA fold the backward sort's payload away.
        def f(m):
            pb = _pair_cols(m)
            w = jnp.arange(pb.rows.size, dtype=jnp.float32).reshape(
                pb.rows.shape
            ) * 1e-7
            return jnp.sum(pb.rows * w)

        return means + jax.grad(f)(means) * 1e-20

    def st_render_bwd(means):
        # cumulative full render fwd + bwd WITHOUT the loss: vs
        # forward_backward the delta is the loss backward; minus
        # blend_kernel_bwd/pairs_bwd deltas it isolates the compose backward
        def f(m):
            img, _ = render(params.replace(means=m), cam, rc)
            return jnp.sum(img)

        return means + jax.grad(f)(means) * 1e-20

    def st_loss(means):
        img, _ = render(params.replace(means=means), cam, rc)
        return means + fold(photometric_loss(img, gt, cfg.loss).grad_loss)

    def st_grad(means):
        def loss(m):
            img, _ = render(params.replace(means=m), cam, rc)
            return photometric_loss(img, gt, cfg.loss).grad_loss

        return means + jax.grad(loss)(means) * 1e-20

    def st_step(state):
        new_state, _ = train_step(state, cam, gt, cfg, 30_000)
        return new_state

    stage_fns = {
        "project": (st_project, params.means, 12),
        "project_pairs": (st_pairs, params.means, 12),
        "blend_inputs": (st_blend_inputs, params.means, 8),
        "blend_fwd": (st_blend_fwd, params.means, 8),
        "blend_kernel_bwd": (st_blend_kernel_bwd, params.means, 6),
        "pairs_bwd": (st_pairs_bwd, params.means, 8),
        "render_bwd": (st_render_bwd, params.means, 6),
        "forward": (st_render, params.means, 8),
        "forward_loss": (st_loss, params.means, 8),
        "forward_backward": (st_grad, params.means, 6),
        "train_step": (st_step, state_mod.create(params), 6),
    }
    results = {}
    for name in names:
        fn, arg0, k_large = stage_fns[name]
        results[name] = loop_time_ms(fn, (arg0,), k_large=k_large, repeats=2)
        if emit:
            emit(name, results[name])
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--pair-block", type=int, default=128)
    p.add_argument(
        "--stages",
        default="project,project_pairs,forward,forward_loss,forward_backward,train_step",
        help="comma-separated subset (each stage costs one ~minutes-long compile)",
    )
    args = p.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    results = stage_times(
        n=args.n, width=args.width, height=args.height,
        pair_capacity=args.pair_capacity, pair_block=args.pair_block,
        names=tuple(args.stages.split(",")),
        emit=lambda name, ms: print(
            json.dumps({"stage": name, "ms": round(ms, 2)}), flush=True
        ),
    )
    print(json.dumps({"stages_ms": {k: round(v, 2) for k, v in results.items()},
                      "device": str(jax.devices()[0])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
