"""Accuracy + end-to-end training-throughput run (the ACCURACY.md setup).

Trains the flagship RouteNet description on synthetic queueing data
(500 train / 100 eval samples, 30 links, 40 paths, len<=6, batch 16) and
reports held-out denormalized R2 / MAPE / MAE plus wall-clock steps/s
(full pipeline: host loader -> merged batches -> device).

Usage: python -m tools.accuracy_run [--steps 2500] [--no-dense] [--cpu]
"""

import argparse
import os
import tempfile
import time

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--no-dense", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = p.parse_args()

    if args.no_dense:
        os.environ["IGNNITION_TPU_DENSE_INC_MAX_ENTRIES"] = "0"

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from ignnition_tpu.data.graph import PaddingConfig
    from ignnition_tpu.data.synthetic import write_dataset
    from ignnition_tpu.frontend import parser
    from ignnition_tpu.model import build
    from ignnition_tpu.training.trainer import Trainer, TrainState
    from __graft_entry__ import _flagship

    root = os.path.join(tempfile.gettempdir(), "ignnition_accuracy_ds")
    train_dir, eval_dir = f"{root}/train", f"{root}/eval"
    if not os.path.isdir(train_dir):
        write_dataset(
            train_dir, 20, 25, seed=0, n_links=30, n_paths=40, max_path_len=6
        )
        write_dataset(
            eval_dir, 4, 25, seed=99, n_links=30, n_paths=40, max_path_len=6
        )

    model_ir = _flagship()
    model = build(model_ir)
    trainer = Trainer(
        model,
        padding=PaddingConfig(mode="multiple", multiple=256, min_size=256),
        compute_dtype=jnp.bfloat16 if args.dtype == "bfloat16" else None,
    )
    state = trainer.init_state(jax.random.PRNGKey(0))

    rng = jax.random.PRNGKey(1)
    it = trainer.batches(train_dir, batch_size=16, shuffle=True, seed=3)
    t0 = time.time()
    t_after_compile = None
    losses = []
    for i in range(args.steps):
        arrays, meta = next(it)
        step = trainer.train_step_fn(meta)
        rng, k = jax.random.split(rng)
        params, opt_state, aux = step(state.params, state.opt_state, arrays, k)
        state = TrainState(params, opt_state, state.step + 1)
        if i == 9:
            float(aux["loss"])  # fence: compile + first steps done
            t_after_compile = time.time()
        if i % 500 == 0 or i == args.steps - 1:
            losses.append((i, float(aux["loss"])))
    float(aux["loss"])
    dt = time.time() - (t_after_compile or t0)
    steady_steps = args.steps - 10
    print(f"train: {args.steps} steps, {time.time()-t0:.1f}s total, "
          f"{steady_steps/dt:.2f} steps/s steady-state "
          f"({steady_steps*16/dt:.1f} graphs/s)")
    for i, l in losses:
        print(f"  step {i:5d} loss {l:.5f}")

    metrics = trainer.evaluate(
        state,
        eval_dir,
        num_batches=100,
        batch_size=1,
        denormalization=lambda x, name: np.exp(x),
    )
    print({k: round(float(v), 5) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
