"""The flash-GAT kernels against XLA's plain dense path, inside the training
step of the attention cell (flagship RouteNet with stage 2 aggregated by
attention, [2048, 16384] incidence matrix), in bf16 and f32 compute.

Both versions are compiled once, then timed in alternating windows
(flash, XLA, XLA, flash, ...) so drift hits both alike; prints every
window and the medians. Also times the per-edge path (no dense incidence
matrix) for reference. GPU only.

Usage: python tools/bench_attention.py [--pairs 5] [--steps 20]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from chip_smoke import attention_lowering  # noqa: E402


def compile_step(make_step, dtype, params, opt_state, arrays, flash):
    """The jitted train step traced with the flash kernels (in either
    dtype, where their tiles fit) or with XLA's dense path."""
    with attention_lowering(flash):
        t0 = time.perf_counter()
        fn = jax.jit(make_step(dtype)).lower(params, opt_state, arrays).compile()
        compile_s = time.perf_counter() - t0
    return fn, compile_s


def window(fn, params, opt_state, arrays, steps):
    p, o = params, opt_state
    t0 = time.perf_counter()
    for _ in range(steps):
        p, o, l = fn(p, o, arrays)
    jax.block_until_ready((p, o, l))
    return (time.perf_counter() - t0) / steps * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU")
    make_step, params, opt_state, arrays, edges = bench.build_case(
        mutate=bench._mutate_attention
    )
    arrays = jax.device_put(arrays)
    per_edge = jax.device_put(
        {k: v for k, v in arrays.items() if not k.startswith("dense_inc_")}
    )
    for dtype in (jnp.bfloat16, jnp.float32):
        name = jnp.dtype(dtype).name
        fns = {}
        for label, flash in (("flash", True), ("xla_dense", False)):
            fns[label], c = compile_step(
                make_step, dtype, params, opt_state, arrays, flash
            )
            print(f"{name} {label}: compile {c:.1f} s", flush=True)
        times = {k: [] for k in fns}
        for i in range(args.pairs):
            order = ("flash", "xla_dense") if i % 2 == 0 else ("xla_dense", "flash")
            for label in order:
                window(fns[label], params, opt_state, arrays, 3)  # settle
                times[label].append(
                    window(fns[label], params, opt_state, arrays, args.steps)
                )
        for label, ts in times.items():
            print(f"{name} {label}: median {np.median(ts):.3f} ms/step "
                  f"({edges / np.median(ts) / 1e3:.1f} Medges/s), windows "
                  f"{[round(t, 3) for t in ts]}", flush=True)
        wins = sum(a < b for a, b in zip(times["flash"], times["xla_dense"]))
        print(f"{name}: flash faster in {wins}/{args.pairs} pairs", flush=True)
        edge_fn, c = compile_step(
            make_step, dtype, params, opt_state, per_edge, False
        )
        ms = np.median([window(edge_fn, params, opt_state, per_edge,
                               args.steps) for _ in range(3)])
        print(f"{name} per-edge path: compile {c:.1f} s, median {ms:.3f} "
              f"ms/step", flush=True)
    print(f"peak device memory "
          f"{jax.devices()[0].memory_stats()['peak_bytes_in_use']} bytes")


if __name__ == "__main__":
    main()
