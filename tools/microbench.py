"""Index-op microbenchmarks on the accelerator: gathers, scatters, sorts
and relayouts at pair scale, the operations the pair pipeline is built from.

Each case is a self-contained jitted loop timed with loop_time_ms (fori-loop
differencing, so per-dispatch host overhead cancels).
Run:  python tools/microbench.py [--cases a,b,c] [--m 2097152]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1 << 21, help="pair-scale index count")
    ap.add_argument("--n", type=int, default=1 << 17, help="gaussian-scale table rows")
    ap.add_argument("--cases", default="")
    args = ap.parse_args(argv)

    from gaussiansplatting.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gaussiansplatting.utils.profiling import loop_time_ms

    m, n = args.m, args.n
    rng = np.random.default_rng(0)
    idx_rand = jnp.asarray(rng.integers(0, n, m), jnp.int32)
    idx_sorted = jnp.sort(idx_rand)
    perm = jnp.asarray(rng.permutation(m), jnp.int32)
    table4 = jnp.asarray(rng.standard_normal((n, 4)), jnp.float32)
    table16 = jnp.asarray(rng.standard_normal((n, 16)), jnp.float32)
    big1 = jnp.asarray(rng.standard_normal(m), jnp.float32)
    big9 = jnp.asarray(rng.standard_normal((m, 9)), jnp.float32)
    big16 = jnp.asarray(rng.standard_normal((m, 16)), jnp.float32)
    keys = jnp.asarray(rng.integers(0, 2000, m), jnp.int32)
    vals = jnp.asarray(rng.standard_normal(m), jnp.float32)

    def tick(x):
        return (jnp.sum(x) * 1e-20).astype(jnp.float32)

    cases = {}

    def case(name):
        def deco(fn):
            cases[name] = fn
            return fn
        return deco

    # ---- gathers ----
    @case("gather_flat_m")
    def _(c):
        return c + tick(big1[(idx_rand + c.astype(jnp.int32)) % n])

    @case("gather_rows4_m")
    def _(c):
        return c + tick(table4[(idx_rand + c.astype(jnp.int32)) % n])

    @case("gather_rows16_m")
    def _(c):
        return c + tick(table16[(idx_rand + c.astype(jnp.int32)) % n])

    @case("gather_rows16_sorted_m")
    def _(c):
        return c + tick(table16[jnp.minimum(idx_sorted + c.astype(jnp.int32), n - 1)])

    @case("gather_perm_rows16")  # permutation of an m-row array (sorted-order materialize)
    def _(c):
        return c + tick(big16[(perm + c.astype(jnp.int32)) % m])

    # ---- scatters ----
    @case("scatter_add_rows9_m")
    def _(c):
        out = jnp.zeros((n, 9), jnp.float32).at[(idx_rand + c.astype(jnp.int32)) % n].add(big9)
        return c + tick(out)

    @case("scatter_add_rows9_sorted_m")
    def _(c):
        out = jnp.zeros((n, 9), jnp.float32).at[jnp.minimum(idx_sorted + c.astype(jnp.int32), n - 1)].add(big9)
        return c + tick(out)

    @case("segment_sum_rows9_sorted")
    def _(c):
        out = jax.ops.segment_sum(
            big9 * (1.0 + c * 0), idx_sorted, num_segments=n,
            indices_are_sorted=True,
        )
        return c + tick(out)

    @case("scatter_set_int_m")  # inverse-permutation build
    def _(c):
        out = jnp.zeros((m,), jnp.int32).at[(perm + c.astype(jnp.int32)) % m].set(
            jnp.arange(m, dtype=jnp.int32)
        )
        return c + tick(out.astype(jnp.float32))

    # ---- sorts ----
    @case("sort_2op")
    def _(c):
        k = keys + c.astype(jnp.int32)
        s = jax.lax.sort((k, vals), num_keys=1)
        return c + tick(s[1])

    @case("sort_4op")
    def _(c):
        k = keys + c.astype(jnp.int32)
        s = jax.lax.sort((k, vals, vals, vals), num_keys=1)
        return c + tick(s[1])

    @case("sort_12op")
    def _(c):
        k = keys + c.astype(jnp.int32)
        ops = (k,) + tuple(big16[:, i] for i in range(11))
        s = jax.lax.sort(ops, num_keys=1)
        return c + tick(s[1])

    @case("sort_gauss_scale")  # per-frame depth sort of gaussians (n rows)
    def _(c):
        k = table16[:, 0] + c
        s = jax.lax.sort((k, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
        return c + tick(s[1].astype(jnp.float32))

    # ---- prefix ops ----
    @case("cumsum_m")
    def _(c):
        return c + tick(jnp.cumsum(big1 + c))

    @case("cumsum_rows9_m")
    def _(c):
        return c + tick(jnp.cumsum(big9 + c, axis=0))

    @case("cummax_m")
    def _(c):
        return c + tick(jax.lax.cummax(big1 + c))

    # ---- round-2 design probes ----
    @case("scatter_set_rows16_unique")  # aligned-layout build by scatter
    def _(c):
        out = jnp.full((m + m // 8, 16), -1.0, jnp.float32).at[
            (perm + c.astype(jnp.int32)) % m
        ].set(big16)
        return c + tick(out)

    @case("scatter_set_rows9_unique")
    def _(c):
        out = jnp.zeros((m + 1, 9), jnp.float32).at[
            (perm + c.astype(jnp.int32)) % m
        ].set(big9)
        return c + tick(out)

    @case("sort_2key_12payload")  # the fat pair sort (tile, depth keys)
    def _(c):
        k1 = keys + c.astype(jnp.int32)
        ops = (k1, vals, idx_rand) + tuple(big16[:, i] for i in range(9))
        s = jax.lax.sort(ops, num_keys=2)
        return c + tick(s[3])

    @case("gather_small_src_n_idx")  # prefix-diff endpoints: n idx from [m,9]
    def _(c):
        srcs = jnp.cumsum(big9, axis=0)
        i = (idx_rand[: args.n] * 16 + c.astype(jnp.int32)) % m
        return c + tick(srcs[i])

    @case("gather_rows12_windows")  # aligned-layout build: piecewise-
    def _(c):                       # consecutive windows from a big source
        # indices: consecutive runs of 128 with random jumps between runs
        starts = (idx_rand[: m // 128] % jnp.int32(m - 128)).astype(jnp.int32)
        win = starts[:, None] + jnp.arange(128, dtype=jnp.int32)[None, :]
        i = (win.reshape(-1) + c.astype(jnp.int32)) % m
        return c + tick(big16[:, :12][i])

    @case("stack9_lane")  # 9 x [m] 1-D -> [m, 9] (lane relayout transpose)
    def _(c):
        cols = [big16[:, i] + c for i in range(9)]
        return c + tick(jnp.stack(cols, axis=-1))

    @case("stack8_sublane")  # 16k x [128] blocks -> [nb, 8, 128] interleave
    def _(c):
        nb = m // 128
        cols = [(big16[:, i] + c).reshape(nb, 128) for i in range(8)]
        return c + tick(jnp.stack(cols, axis=1))

    @case("gather_flat_1m2")  # endpoint gather at D*N flat indices
    def _(c):
        idx = (jnp.tile(idx_rand[: args.n], 9) + c.astype(jnp.int32)) % m
        return c + tick(big1[idx])

    @case("cumsum_20m")  # fused column cumsum
    def _(c):
        x = jnp.tile(big1, 9) + c
        return c + tick(jnp.cumsum(x))

    @case("sort_2op_3m")  # sort scaling to 3.2M (dense two-tier expansion)
    def _(c):
        k = jnp.tile(keys, 2)[: 3 * m // 2] + c.astype(jnp.int32)
        v = jnp.tile(vals, 2)[: 3 * m // 2]
        s = jax.lax.sort((k, v), num_keys=1)
        return c + tick(s[1])

    # ---- LIVE-payload sorts: every output consumed.  The earlier sort
    # cases let XLA DCE unused payload operands entirely — measured cost
    # was a 1-2 operand sort regardless of the declared operand count. ----
    def _live_sort(c, cols, nkeys=1):
        k = keys + c.astype(jnp.int32)
        s = jax.lax.sort((k,) + tuple(cols), num_keys=nkeys)
        return c + sum(tick(x.astype(jnp.float32)) for x in s[1:])

    @case("sortlive_1op_f32")
    def _(c):
        return _live_sort(c, (vals,))

    @case("sortlive_4op_f32")
    def _(c):
        return _live_sort(c, tuple(big16[:, i] for i in range(4)))

    @case("sortlive_10op_f32")
    def _(c):
        return _live_sort(c, tuple(big16[:, i] for i in range(10)))

    @case("sortlive_10op_bf16")
    def _(c):
        cols = tuple(big16[:, i].astype(jnp.bfloat16) for i in range(10))
        return _live_sort(c, cols)

    @case("sortlive_10op_i8")
    def _(c):
        cols = tuple((idx_rand + i).astype(jnp.int8) for i in range(10))
        return _live_sort(c, cols)

    @case("sortlive_5op_i32packed")  # 10 bf16 halves packed into 5 i32
    def _(c):
        cols = tuple(
            (big16[:, 2 * i].astype(jnp.bfloat16).view(jnp.uint16)
             .astype(jnp.uint32) << 16
             | big16[:, 2 * i + 1].astype(jnp.bfloat16).view(jnp.uint16)
             .astype(jnp.uint32)).astype(jnp.int32)
            for i in range(5)
        )
        return _live_sort(c, cols)

    @case("transpose_rows9_to_cols")  # [m, 9] -> [9, m] lane relayout
    def _(c):
        return c + tick((big9 + c).T)

    @case("stack9_lane_live")  # 9 x [m] -> [m, 9]
    def _(c):
        cols = [big16[:, i] + c for i in range(9)]
        return c + tick(jnp.stack(cols, axis=-1))

    sel = args.cases.split(",") if args.cases else list(cases)
    results = {}
    for name in sel:
        ms = loop_time_ms(cases[name], (jnp.float32(0.0),), k_large=16, repeats=2)
        results[name] = round(ms, 3)
        print(json.dumps({"case": name, "ms": results[name]}), flush=True)
    print(json.dumps({"m": m, "n": n, "results": results,
                      "device": str(jax.devices()[0])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
