"""Inference (serving) throughput: forward-only jitted predict at flagship
shapes, bf16 and f32."""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

import bench


def main():
    make_step, params, opt_state, arrays, edges = bench.build_case()
    meta = make_step.meta
    model = make_step.model
    arrays = jax.device_put(arrays)

    for dtype, name in ((jnp.bfloat16, "bf16"), (None, "f32")):

        def mk(dtype=dtype):
            def fwd(p, b):
                return model.apply(p, b, meta, compute_dtype=dtype)

            return fwd

        f = jax.jit(mk())
        out = f(params, arrays)
        float(jnp.sum(out.astype(jnp.float32)))
        t0 = time.time()
        out = f(params, arrays)
        float(jnp.sum(out.astype(jnp.float32)))
        base = time.time() - t0
        iters = 50
        t0 = time.time()
        acc = None
        for _ in range(iters):
            out = f(params, arrays)
        float(jnp.sum(out.astype(jnp.float32)))
        dt = max(time.time() - t0 - base, 1e-9) / (iters - 1)
        print(
            f"predict {name}: {dt*1e3:.3f} ms/batch "
            f"({edges/dt/1e6:.1f} Medges/s, "
            f"{16384/dt:.0f} paths/s per batch of 16384)"
        )


if __name__ == "__main__":
    main()
