"""Generate the synthetic photoreal-ish COLMAP dataset (utils/scenegen.py).

  python -m gaussiansplatting.tools.make_dataset --out /path/scene \
      [--views 200] [--width 800] [--height 608] [--points 150000]

Then train on it like any COLMAP scene:
  python -m gaussiansplatting.tools.train --colmap /path/scene/sparse/0 \
      --images /path/scene/images ...
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--views", type=int, default=200)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--points", type=int, default=150_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fov", type=float, default=60.0)
    args = p.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from gaussiansplatting.utils.scenegen import generate_dataset

    generate_dataset(
        args.out, num_views=args.views, width=args.width, height=args.height,
        num_points=args.points, seed=args.seed, fov_deg=args.fov,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
