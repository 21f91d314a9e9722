"""Benchmark: edges/s of the message-passing training step, on the GPU.

Runs the flagship RouteNet model (8 MP iterations, hs=32, GRU updates,
256-256-1 readout — reference examples/Routenet/model_description.json) and
its model-family variants on large synthetic graph batches, and measures
the full training step (bf16 compute, batch resident on the device) in
processed edge-messages per second. Prints one JSON row per cell; every
row names the platform, device kind and device count, and carries the
roofline share against the device's published peaks (utils/roofline.py).
Refuses to run without a GPU: a CPU number is not a device metric.

Usage: python bench.py [--cells flagship,attention,...] [--iters N]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402


def build_case(
    n_links=int(os.environ.get("BENCH_LINKS", 2048)),
    n_paths=int(os.environ.get("BENCH_PATHS", 16384)),
    path_len=8,
    hs=32,
    iterations=8,
    mutate=None,
    n_graphs=1,
    per_graph=False,
):
    import jax

    from __graft_entry__ import _flagship
    from ignnition_tpu.data import SampleSpec, build_batch
    from ignnition_tpu.data.dataset import GraphSample, AdjacencyArrays
    from ignnition_tpu.data.graph import PaddingConfig
    from ignnition_tpu.model import build
    from ignnition_tpu.training import build_optimizer, get_loss

    model_ir = _flagship(num_iterations=iterations, hs=hs, mutate=mutate)
    rng = np.random.default_rng(0)

    def one_sample():
        # direct array construction (dict-of-lists conversion would dominate
        # setup time at this scale)
        links = rng.integers(0, n_links, size=(n_paths, path_len))
        src_lp = links.reshape(-1).astype(np.int32)
        dst_lp = np.repeat(np.arange(n_paths, dtype=np.int32), path_len)
        seq_lp = np.tile(np.arange(path_len, dtype=np.int32), n_paths)
        order = np.argsort(src_lp, kind="stable")
        src_pl = dst_lp[order].copy()
        dst_pl = src_lp[order].copy()
        counts = np.bincount(dst_pl, minlength=n_links)
        seq_pl = (
            np.concatenate([np.arange(c, dtype=np.int32) for c in counts])
            if counts.sum()
            else np.zeros(0, np.int32)
        )
        return GraphSample(
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

    samples = [one_sample() for _ in range(n_graphs)]
    arrays, meta = build_batch(
        samples,
        model_ir,
        PaddingConfig(
            mode="multiple", multiple=256, min_size=256, per_graph=per_graph
        ),
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

    make_step.meta = meta  # for tools that need the static batch meta
    make_step.model = model
    make_step.model_ir = model_ir
    real_edges = sum(
        len(s.adjacencies[a].src_idx)
        for s in samples
        for a in ("adj_links_paths", "adj_paths_links")
    )
    edges_per_step = iterations * real_edges
    return make_step, params, opt_state, arrays, edges_per_step


def time_step(step, params, opt_state, arrays, iters=50):
    """Steady per-step seconds with the batch resident on the device: host
    clock around `iters` chained steps that end in block_until_ready."""
    import jax

    arrays = jax.device_put(arrays)
    fn = jax.jit(step)
    p, o, l = fn(params, opt_state, arrays)  # compile + warm
    jax.block_until_ready((p, o, l))
    t0 = time.perf_counter()
    for _ in range(iters):
        p, o, l = fn(p, o, arrays)
    jax.block_until_ready((p, o, l))
    return (time.perf_counter() - t0) / iters


def _mutate_mlp_message(description):
    """Per-edge message MLP over concat(hs_source, hs_dest) on both stages
    (the 'per-edge message models' family, PERF.md)."""
    description["neural_networks"].append(
        {
            "nn_name": "bench_msg",
            "nn_type": "feed_forward",
            "nn_architecture": [
                {"type_layer": "Dense", "units": 32, "activation": "relu"},
                {"type_layer": "Dense", "units": 32, "activation": "None"},
            ],
        }
    )
    for stage in description["message_passing"]["stages"]:
        for mp in stage["stage_mp"]:
            for se in mp["source_entities"]:
                se["message"] = [
                    {
                        "type": "neural_network",
                        "nn_name": "bench_msg",
                        "input": ["hs_source", "hs_dest"],
                    }
                ]


def _mutate_attention(description):
    description["message_passing"]["stages"][1]["stage_mp"][0][
        "aggregation"
    ] = {"type": "attention"}


def detail_cases():
    """(name -> case builder). Each returns (make_step, params, opt_state,
    arrays, edges_per_step)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))

    def qsize():
        import bench_qsize

        return bench_qsize.build_case()

    return {
        "flagship": build_case,
        "attention": lambda: build_case(mutate=_mutate_attention),
        "mlp_message": lambda: build_case(mutate=_mutate_mlp_message),
        "qsize": qsize,
        "blocks_g4": lambda: build_case(
            n_paths=4096, n_links=512, n_graphs=4, per_graph=True
        ),
        # 4x / 8x the flagship single graph: above the dense-incidence cap
        "flagship_x4": lambda: build_case(n_links=8192, n_paths=65536),
        "flagship_x8": lambda: build_case(n_links=16384, n_paths=131072),
    }


def card_info() -> str:
    """nvidia-smi's name and power limit of the cards (a card below its
    maximum limit runs slower under load, so every number carries it)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out


def device_fields():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card_info().splitlines()[0]}


def run_cell(name, builder, iters):
    import jax.numpy as jnp

    from ignnition_tpu.utils.roofline import roofline_report

    make_step, params, opt_state, arrays, edges = builder()
    dt = time_step(make_step(jnp.bfloat16), params, opt_state, arrays,
                   iters=iters)
    dev = device_fields()
    rep = roofline_report(make_step.model_ir, make_step.meta, dt * 1e3,
                          dev["device_kind"])
    return {
        "cell": name,
        "value": edges / dt / 1e6,
        "unit": "Medges/s",
        "ms_per_step": dt * 1e3,
        "sol_ms": rep["sol_ms"],
        "sol_pct": rep["sol_pct"],
        "binding": rep["binding"],
        **dev,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="flagship,attention")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    enable_compilation_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {jax.devices()[0]}")
    cases = detail_cases()
    for name in args.cells.split(","):
        print(json.dumps(run_cell(name, cases[name], args.iters)), flush=True)


if __name__ == "__main__":
    main()
