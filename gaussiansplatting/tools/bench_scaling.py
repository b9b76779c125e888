"""Scaling-efficiency benchmark: sharded train step at 1, 2, 4, ... devices
(BASELINE.md config #5).  On several GPUs this measures collective scaling;
on a virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N) it
validates the sharded program end to end.

  python -m gaussiansplatting.tools.bench_scaling [--n 100000]
      [--width 800 --height 608] [--steps 10] [--coordinator host:port]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--pair-capacity", type=int, default=1 << 20,
                   help="per-device pair capacity")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--coordinator", default=None, help="multi-host coordinator host:port")
    args = p.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import numpy as np
    import jax

    from gaussiansplatting.config import Config, RasterConfig
    from gaussiansplatting.parallel import launch, mesh as mesh_mod
    from gaussiansplatting.parallel.sharded import make_sharded_train_step
    from gaussiansplatting.train import state as state_mod
    from gaussiansplatting.utils import synthetic

    topo = launch.initialize(coordinator=args.coordinator)
    print(json.dumps({"topology": topo}), flush=True)

    cfg = Config(raster=RasterConfig(pair_capacity=args.pair_capacity))
    params = synthetic.make_scene(n=args.n, seed=0)
    camera = synthetic.make_canonical_camera(args.width, args.height)
    gt = np.asarray(
        np.random.default_rng(1).uniform(0, 1, (args.height, args.width, 3)),
        np.float32,
    )

    n_total = len(jax.devices())
    sizes = []
    d = 1
    while d <= n_total:
        sizes.append(d)
        d *= 2
    if sizes[-1] != n_total:
        sizes.append(n_total)

    results = []
    base = None
    for nd in sizes:
        step = make_sharded_train_step(mesh_mod.make_mesh(nd), cfg, 30_000)
        st = state_mod.create(params)
        st, m = step(st, camera, gt)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            st, m = step(st, camera, gt)
        jax.block_until_ready(st)
        float(m.loss)
        dt = (time.perf_counter() - t0) / args.steps
        ips = 1.0 / dt
        if base is None:
            base = ips
        eff = ips / (base * nd)
        results.append({"devices": nd, "iters_per_sec": round(ips, 3),
                        "scaling_efficiency": round(eff, 3)})
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"metric": "scaling", "results": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
