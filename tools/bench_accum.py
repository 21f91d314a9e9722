"""Effective-4x batch via gradient accumulation over four 1x microbatches
vs the native 4x merged batch (PERF.md batch-size scaling)."""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

import bench
from ignnition_tpu.data.graph import PaddingConfig
from ignnition_tpu.training.trainer import Trainer


def main():
    make_step, params, opt_state, arrays, edges = bench.build_case()
    meta = make_step.meta
    trainer = Trainer(
        make_step.model,
        padding=PaddingConfig(mode="multiple", multiple=256, min_size=256),
        compute_dtype=jnp.bfloat16,
    )
    # four copies of the x1 batch stacked on a leading axis (identical
    # shapes, so no repad needed); different content is irrelevant to timing
    stacked = jax.device_put(
        {k: np.stack([v] * 4, axis=0) for k, v in arrays.items()}
    )
    step = trainer.accum_train_step_fn(meta, 4)
    rng = jax.random.PRNGKey(0)

    p, o, logs = step(params, opt_state, stacked, rng)
    float(logs["loss"])
    t0 = time.time()
    p, o, logs = step(params, opt_state, stacked, rng)
    float(logs["loss"])
    base = time.time() - t0
    iters = 20
    t0 = time.time()
    p, o = params, opt_state
    for _ in range(iters):
        p, o, logs = step(p, o, stacked, rng)
    float(logs["loss"])
    dt = max(time.time() - t0 - base, 1e-9) / (iters - 1)
    eff_edges = 4 * edges
    print(
        f"accum 4 x 1x: {dt*1e3:.3f} ms/optimizer-step "
        f"({eff_edges/dt/1e6:.1f} Medges/s effective)"
    )


if __name__ == "__main__":
    main()
