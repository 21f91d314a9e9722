"""Q-size-shaped training-step benchmark at flagship scale: interleave
{link,node}->path (GRU sorted update) + two path->{link,node} sums.

Measures the second example family's hot loop — the interleave aggregation
(scatter into padded blocks + take_along_axis permutation + masked GRU) —
which the flagship RouteNet bench never exercises."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np


def build_case(n_links=2048, n_nodes=2048, n_paths=16384, hops=4, hs=32,
               iterations=8):
    import jax

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
    from helpers import qsize_description

    from ignnition_tpu.data.dataset import GraphSample, AdjacencyArrays
    from ignnition_tpu.data.graph import PaddingConfig, build_batch
    from ignnition_tpu.frontend.parser import parse_model_description
    from ignnition_tpu.model import build
    from ignnition_tpu.training import build_optimizer, get_loss

    dims = {"link_capacity": 1, "traffic": 1, "queue_sizes": 1}
    model_ir = parse_model_description(
        qsize_description(num_iterations=iterations, hs=hs), dims
    )
    rng = np.random.default_rng(0)

    # each path: `hops` links and `hops` nodes, interleaved link,node,...
    def stage1(n_src):
        picks = rng.integers(0, n_src, size=(n_paths, hops))
        src = picks.reshape(-1).astype(np.int32)
        dst = np.repeat(np.arange(n_paths, dtype=np.int32), hops)
        seq = np.tile(np.arange(hops, dtype=np.int32), n_paths)
        return src, dst, seq

    def reverse(src, dst, n_dst_rev):
        order = np.argsort(src, kind="stable")
        rsrc, rdst = dst[order].copy(), src[order].copy()
        counts = np.bincount(rdst, minlength=n_dst_rev)
        rseq = (
            np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
            if counts.sum()
            else np.zeros(0, np.int32)
        )
        return rsrc, rdst, rseq

    s_lp = stage1(n_links)
    s_np = stage1(n_nodes)
    s_pl = reverse(s_lp[0], s_lp[1], n_links)
    s_pn = reverse(s_np[0], s_np[1], n_nodes)

    t_out = 2 * hops
    interleave = {
        ("link", "path"): (2 * np.arange(hops)).astype(np.int64),
        ("node", "path"): (2 * np.arange(hops) + 1).astype(np.int64),
    }
    sample = GraphSample(
        num_nodes={"link": n_links, "node": n_nodes, "path": n_paths},
        features={
            "link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
            "queue_sizes": rng.uniform(1, 8, (n_nodes, 1)).astype(np.float32),
            "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32),
        },
        adjacencies={
            "adj_links_paths": AdjacencyArrays(*s_lp),
            "adj_nodes_paths": AdjacencyArrays(*s_np),
            "adj_paths_links": AdjacencyArrays(*s_pl),
            "adj_paths_nodes": AdjacencyArrays(*s_pn),
        },
        interleave=interleave,
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )
    arrays, meta = build_batch(
        [sample], model_ir, PaddingConfig(mode="multiple", multiple=256, min_size=256)
    )
    model = build(model_ir)
    params = model.init(jax.random.PRNGKey(0))
    optimizer = build_optimizer(model_ir.learning.optimizer)
    opt_state = optimizer.init(params)
    loss_fn = get_loss(model_ir.learning.loss)

    import optax

    def make_step(compute_dtype=None):
        def train_step(params, opt_state, batch):
            def loss(p):
                preds = model.apply(
                    p, batch, meta, training=True, compute_dtype=compute_dtype
                )
                return loss_fn(batch["label"], preds, batch["label_mask"])

            l, grads = jax.value_and_grad(loss)(params)
            updates, opt_state2 = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state2, l

        return train_step

    edges = iterations * sum(len(a[0]) for a in (s_lp, s_np, s_pl, s_pn))
    make_step.meta = meta
    make_step.model = model
    make_step.model_ir = model_ir
    return make_step, params, opt_state, arrays, edges


def main():
    import jax
    import jax.numpy as jnp

    import bench

    make_step, params, opt_state, arrays, edges = build_case()
    dt = bench.time_step(make_step(jnp.bfloat16), params, opt_state, arrays)
    print(
        f"qsize train step: {dt*1e3:.3f} ms/step ({edges/dt/1e6:.1f} Medges/s)"
    )


if __name__ == "__main__":
    main()
