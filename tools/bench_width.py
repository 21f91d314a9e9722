"""Hidden-size scaling probe: flagship step throughput at hs=32/64/128.

The headline bench (bench.py) fixes hs=32 (the reference RouteNet config,
examples/Routenet/model_description.json:6). Real users vary the hidden
size; this probe checks the optimized path holds up as per-edge/per-node
byte traffic grows (packed segment kernel covers any D dividing 128; the
dense-incidence matmul is width-independent; GRU gate traffic scales
linearly).

Usage: python tools/bench_width.py [hs ...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def main():
    import jax.numpy as jnp

    import bench

    widths = [int(a) for a in sys.argv[1:]] or [32, 64, 128]
    for hs in widths:
        make_step, params, opt_state, arrays, edges = bench.build_case(hs=hs)
        dt = bench.time_step(make_step(jnp.bfloat16), params, opt_state, arrays, iters=30)
        print(
            f"hs={hs:4d}: {dt * 1e3:7.2f} ms/step  "
            f"{edges / dt / 1e6:7.1f} Medges/s  "
            f"({edges * hs * 2 / dt / 1e9:6.1f} GB/s edge-state traffic floor)"
        )


if __name__ == "__main__":
    main()
