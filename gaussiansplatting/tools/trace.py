"""Device-trace capture + aggregation for the train step.

Cumulative stage probes mislead (XLA drops unused sort payloads and
unconsumed outputs, so deltas between differently-pruned programs are not
stage costs), so the per-op instrument is a device trace of a few real
steps.

  python -m gaussiansplatting.tools.trace [--steps 5] [--n 100000]
      [--width 800 --height 608] [--pair-capacity 2097152]
      [--top 25] [--out gs_trace]

Captures ``jax.profiler.trace`` around N already-compiled steps, then
parses the Perfetto/Chrome trace.json.gz it writes, keeps the device compute lane
(the pid whose events carry run ids / XLA op names, not the python host
threads), groups op durations by fusion-name prefix, and prints the top
groups in ms/step.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os


def capture(steps, n, width, height, pair_capacity, out):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from gaussiansplatting.config import Config, LossConfig, RasterConfig
    from gaussiansplatting.train import state as train_state
    from gaussiansplatting.train.trainer import train_step
    from gaussiansplatting.utils import synthetic

    cfg = Config(
        raster=RasterConfig(
            pair_capacity=pair_capacity, pair_block=128,
        ),
        loss=LossConfig(dssim_in_grad=False),
    )
    params = synthetic.make_scene(n=n, seed=0)
    camera = synthetic.make_canonical_camera(width=width, height=height)
    gt = np.asarray(
        np.random.default_rng(1).uniform(0, 1, (height, width, 3)), np.float32
    )
    st = train_state.create(params)
    st, _ = train_step(st, camera, gt, cfg, 30_000)   # compile
    jax.block_until_ready(st)

    with jax.profiler.trace(out, create_perfetto_trace=True):
        for _ in range(steps):
            st, _ = train_step(st, camera, gt, cfg, 30_000)
        jax.block_until_ready(st)
    return out


def _group_name(name: str) -> str:
    """Collapse an XLA op/fusion name to a stable prefix for aggregation."""
    base = name.split("/")[0]
    # strip trailing .N / numeric suffixes so fusion.123 groups as fusion
    while base and (base[-1].isdigit() or base[-1] == "."):
        base = base[:-1]
    return base or name


def aggregate(trace_dir: str, steps: int, top: int = 25) -> list[tuple[str, float]]:
    """Parse the newest .trace.json.gz under trace_dir; return
    [(group, ms_per_step)] sorted desc over the device compute lane."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*trace.json.gz"),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no *trace.json.gz under {trace_dir}")
    with gzip.open(paths[-1], "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])

    # identify device lanes: pids whose process_name metadata mentions the
    # accelerator (GPU/device); fall back to the pid with the largest
    # total 'X' duration that is not a python/host thread
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e.get("pid")] = e.get("args", {}).get("name", "")
    device_pids = {
        p for p, nm in pid_names.items()
        if any(k in nm.lower() for k in ("gpu", "device", "xla"))
        and "host" not in nm.lower()
    }
    if not device_pids:
        totals = collections.Counter()
        for e in events:
            if e.get("ph") == "X":
                totals[e.get("pid")] += e.get("dur", 0)
        if totals:
            device_pids = {totals.most_common(1)[0][0]}

    host_markers = ("$", "block_until_ready", "ThunkExecutor", "trace",
                    "__exit__", "WaitFor")
    # device pids carry SEVERAL lanes (XLA Modules = one giant span per
    # step, XLA Ops = the per-fusion compute lane, Steps...).  Summing all
    # of them double-counts every op inside its module span, so keep ONE
    # tid: the thread named "XLA Ops" when present, else the tid with the
    # most events (fusions vastly outnumber module spans).
    tid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e.get("pid"), e.get("tid"))] = (
                e.get("args", {}).get("name", "")
            )
    op_lanes = {
        k for k, nm in tid_names.items()
        if k[0] in device_pids and "op" in nm.lower()
    }
    if not op_lanes:
        per_tid = collections.Counter()
        for e in events:
            if e.get("ph") == "X" and e.get("pid") in device_pids:
                per_tid[(e.get("pid"), e.get("tid"))] += 1
        if per_tid:
            op_lanes = {per_tid.most_common(1)[0][0]}
    groups = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or (e.get("pid"), e.get("tid")) not in op_lanes:
            continue
        name = e.get("name", "?")
        if any(m in name for m in host_markers):
            continue
        groups[_group_name(name)] += e.get("dur", 0)
    total = sum(groups.values())
    out = [
        (name, dur / 1e3 / steps)
        for name, dur in groups.most_common(top)
    ]
    out.append(("TOTAL(device)", total / 1e3 / steps))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default="gs_trace")
    p.add_argument("--parse-only", action="store_true",
                   help="skip capture; aggregate an existing --out dir")
    args = p.parse_args(argv)

    if not args.parse_only:
        from gaussiansplatting.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        capture(args.steps, args.n, args.width, args.height,
                args.pair_capacity, args.out)
    for name, ms in aggregate(args.out, args.steps, args.top):
        print(f"{ms:9.3f} ms/step  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
