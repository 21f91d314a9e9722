"""Decompose the flagship training step cost (bf16 headline config):
forward-only, forward+backward, full step; and per-stage variants.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from bench import build_case, time_step


def time_fn(fn, args, iters=40):
    """Per-call seconds of jit(fn), timed by fetching the output's first
    leaf to the host (which waits for the device)."""
    fn = jax.jit(fn)
    out = fn(*args)
    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(leaf)
    t0 = time.time()
    out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    t_base = time.time() - t0
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    t_n = time.time() - t0
    return max(t_n - t_base, 1e-9) / (iters - 1)


def main():
    from __graft_entry__ import _flagship
    from ignnition_tpu.model import build
    from ignnition_tpu.training import get_loss

    make_step, params, opt_state, arrays, edges_per_step = build_case()
    arrays = jax.device_put(arrays)

    model_ir = _flagship()
    model = build(model_ir)
    loss_fn = get_loss(model_ir.learning.loss)

    import bench

    meta = None
    # rebuild meta the same way bench does (build_case hides it): call again
    # cheaply via a fresh build_case would duplicate; instead reach into bench
    # by rebuilding the small parts
    from ignnition_tpu.data import build_batch
    # meta comes with arrays inside build_case; easiest: recreate
    mk, p2, o2, arrays2, _ = build_case()
    # we need meta: rebuild via build_case internals is awkward; instead use
    # the flagship entry used by the model: capture from a wrapper

    # --- simpler: pull meta via build_case's closure is not possible; rebuild
    from ignnition_tpu.data.dataset import GraphSample, AdjacencyArrays
    from ignnition_tpu.data.graph import PaddingConfig
    rng = np.random.default_rng(0)
    n_links, n_paths, path_len = 2048, 16384, 8
    links = rng.integers(0, n_links, size=(n_paths, path_len))
    src_lp = links.reshape(-1).astype(np.int32)
    dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
    seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
    order = np.argsort(src_lp, kind="stable")
    src_pl = dst_lp[order].copy()
    dst_pl = src_lp[order].copy()
    counts = np.bincount(dst_pl, minlength=n_links)
    seq_pl = np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
    sample = GraphSample(
        num_nodes={"link": n_links, "path": n_paths},
        features={
            "link_capacity": rng.uniform(20, 40, (n_links, 1)).astype(np.float32),
            "traffic": rng.uniform(0.2, 0.8, (n_paths, 1)).astype(np.float32),
        },
        adjacencies={
            "adj_links_paths": AdjacencyArrays(src_lp, dst_lp, seq_lp),
            "adj_paths_links": AdjacencyArrays(src_pl, dst_pl, seq_pl),
        },
        label=rng.uniform(0.1, 1.0, n_paths).astype(np.float32),
    )
    _, meta = build_batch([sample], model_ir, PaddingConfig(mode="multiple", multiple=256, min_size=256))

    cd = jnp.bfloat16

    def fwd(p, batch):
        preds = model.apply(p, batch, meta, training=True, compute_dtype=cd)
        return loss_fn(batch["label"], preds, batch["label_mask"])

    def fwdbwd(p, batch):
        return jax.value_and_grad(fwd)(p, batch)

    dt_f = time_fn(fwd, (params, arrays))
    print(f"forward only:   {dt_f*1e3:7.2f} ms", flush=True)
    dt_fb = time_fn(fwdbwd, (params, arrays))
    print(f"fwd+bwd:        {dt_fb*1e3:7.2f} ms", flush=True)
    dt_full = time_step(make_step(cd), params, opt_state, arrays, iters=40)
    print(f"full step:      {dt_full*1e3:7.2f} ms", flush=True)

    # per-stage: 1-iteration model fwd/bwd to estimate per-iteration body cost
    ir1 = _flagship(num_iterations=1)
    model1 = build(ir1)

    def fwd1(p, batch):
        preds = model1.apply(p, batch, meta, training=True, compute_dtype=cd)
        return loss_fn(batch["label"], preds, batch["label_mask"])

    dt1f = time_fn(fwd1, (params, arrays))
    dt1fb = time_fn(lambda p, b: jax.value_and_grad(fwd1)(p, b), (params, arrays))
    print(f"1-iter fwd:     {dt1f*1e3:7.2f} ms   (per-iter fwd ~{(dt_f-dt1f)/7*1e3:6.2f} ms)", flush=True)
    print(f"1-iter fwd+bwd: {dt1fb*1e3:7.2f} ms   (per-iter fb  ~{(dt_fb-dt1fb)/7*1e3:6.2f} ms)", flush=True)


if __name__ == "__main__":
    main()
