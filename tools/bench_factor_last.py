"""A/B the factored-last-Dense rewrite on the per-edge message family:
MLP([hs_source, hs_dest]) messages (Dense(relu) -> Dense(None)) on both
flagship stages, factored (last matmul at node rate) vs unfactored
(edge rate), at flagship shapes. The factoring only engages on the sum
stage (stage2); stage1 is ordered."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

import bench
from ignnition_tpu.model import builder as B


def main():
    make_step, params, opt_state, arrays, edges = bench.build_case(
        mutate=bench._mutate_mlp_message
    )
    arrays = jax.device_put(arrays)

    def timeit(f, iters=30):
        p, o, l = f(params, opt_state, arrays)
        float(l)
        t0 = time.time()
        p, o, l = f(params, opt_state, arrays)
        float(l)
        base = time.time() - t0
        t0 = time.time()
        p, o = params, opt_state
        for _ in range(iters):
            p, o, l = f(p, o, arrays)
        float(l)
        return max(time.time() - t0 - base, 1e-9) / (iters - 1)

    B._FACTOR_LAST = True
    dt_f = timeit(jax.jit(make_step(jnp.bfloat16)))
    B._FACTOR_LAST = False
    try:
        dt_u = timeit(jax.jit(make_step(jnp.bfloat16)))
    finally:
        B._FACTOR_LAST = True

    print(f"per-edge MLP factored:   {dt_f*1e3:.3f} ms/step ({edges/dt_f/1e6:.1f} Medges/s)")
    print(f"per-edge MLP unfactored: {dt_u*1e3:.3f} ms/step ({edges/dt_u/1e6:.1f} Medges/s)")
    print(f"speedup: {dt_u/dt_f:.3f}x")


if __name__ == "__main__":
    main()
