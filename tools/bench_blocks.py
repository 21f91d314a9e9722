#!/usr/bin/env python
"""A/B: block-diagonal batched incidence matmul vs the gather paths on
MERGED multi-graph batches (the real-training large-batch case).

The dense merged matrix overflows its cap at G>=2 flagship-sized graphs
(G^2 * 33M entries), so before the block path these batches fell back to the
gather/segment lowering and scaled sub-linearly (PERF.md "Batch-size
scaling"). Blocks hold G * 33M entries — linear — and need no gathers on
uniform batches.

Usage: python tools/bench_blocks.py [G ...]   (default: 2 4)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np


def build_merged_case(n_graphs, n_links=2048, n_paths=16384, path_len=8, stage2_agg=None):
    import jax

    from __graft_entry__ import _flagship
    from ignnition_tpu.data import build_batch
    from ignnition_tpu.data.dataset import AdjacencyArrays, GraphSample
    from ignnition_tpu.data.graph import PaddingConfig
    from ignnition_tpu.model import build
    from ignnition_tpu.training import build_optimizer, get_loss

    model_ir = _flagship(num_iterations=8, hs=32)
    if stage2_agg is not None:
        # swap stage2 (path -> link sum) for the requested aggregation
        from dataclasses import replace

        mp = model_ir.stages[1].passes[0]
        mp2 = replace(mp, aggregation=replace(mp.aggregation, kind=stage2_agg))
        model_ir = replace(
            model_ir,
            stages=(
                model_ir.stages[0],
                replace(model_ir.stages[1], passes=(mp2,)),
            ),
        )
    rng = np.random.default_rng(0)

    samples = []
    for _ in range(n_graphs):
        links = rng.integers(0, n_links, size=(n_paths, path_len))
        src_lp = links.reshape(-1).astype(np.int32)
        dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
        seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
        order = np.argsort(src_lp, kind="stable")
        src_pl = dst_lp[order].copy()
        dst_pl = src_lp[order].copy()
        counts = np.bincount(dst_pl, minlength=n_links)
        seq_pl = np.concatenate(
            [np.arange(c, dtype=np.int32) for c in counts]
        ) if counts.sum() else np.zeros(0, np.int32)
        samples.append(
            GraphSample(
                num_nodes={"link": n_links, "path": n_paths},
                features={
                    "link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(
                        np.float32
                    ),
                    "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(
                        np.float32
                    ),
                },
                adjacencies={
                    "adj_links_paths": AdjacencyArrays(src_lp, dst_lp, seq_lp),
                    "adj_paths_links": AdjacencyArrays(src_pl, dst_pl, seq_pl),
                },
                label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
            )
        )

    arrays, meta = build_batch(
        samples, model_ir, PaddingConfig(mode="multiple", multiple=256, min_size=256)
    )
    model = build(model_ir)
    params = model.init(jax.random.PRNGKey(0))
    optimizer = build_optimizer(model_ir.learning.optimizer)
    opt_state = optimizer.init(params)
    loss_fn = get_loss(model_ir.learning.loss)

    import optax

    def train_step(params, opt_state, batch):
        def loss(p):
            preds = model.apply(
                p, batch, meta, training=True, compute_dtype="bfloat16"
            )
            return loss_fn(batch["label"], preds, batch["label_mask"])

        l, grads = jax.value_and_grad(loss)(params)
        updates, opt_state2 = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, l

    edges_per_step = 8 * n_graphs * 2 * n_paths * path_len
    return train_step, params, opt_state, arrays, edges_per_step


def main():
    from bench import time_step

    agg = None
    args = []
    for a in sys.argv[1:]:
        if a.startswith("--agg="):
            agg = a.split("=", 1)[1]
        else:
            args.append(int(a))
    for n_graphs in args or [2, 4]:
        step, params, opt_state, arrays, edges = build_merged_case(
            n_graphs, stage2_agg=agg
        )
        blocked = {
            k: v for k, v in arrays.items() if not k.startswith("inc_blocks_")
        }
        has_blocks = len(blocked) != len(arrays)
        t_blocks = time_step(step, params, opt_state, arrays, iters=30)
        t_plain = time_step(step, params, opt_state, blocked, iters=30)
        print(
            f"G={n_graphs}: blocks={'yes' if has_blocks else 'NO'} "
            f"{t_blocks*1e3:.2f} ms ({edges/t_blocks/1e6:.1f} Medges/s) | "
            f"gather path {t_plain*1e3:.2f} ms ({edges/t_plain/1e6:.1f} Medges/s) "
            f"| {t_plain/t_blocks:.2f}x"
        )


if __name__ == "__main__":
    main()
