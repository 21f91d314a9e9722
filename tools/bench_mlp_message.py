"""A/B the source-local message generalization: MLP(hs_source) messages on
both flagship stages, node-table evaluation (MLP per NODE + fused/dense
aggregation paths) vs the per-edge formulation (gather -> MLP per EDGE +
segment ops), at flagship shapes."""

import copy
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

import bench
from ignnition_tpu.frontend import ir as IR
from ignnition_tpu.frontend import parser as P


def main():
    hs = 32
    real_parse = P.parse_model_description

    def patched_parse(description, dims):
        d = copy.deepcopy(description)
        d["neural_networks"].append(
            {
                "nn_name": "src_msg",
                "nn_type": "feed_forward",
                "nn_architecture": [
                    {"type_layer": "Dense", "units": hs, "activation": "relu"},
                    {"type_layer": "Dense", "units": hs, "activation": "None"},
                ],
            }
        )
        msg = [
            {
                "type": "neural_network",
                "nn_name": "src_msg",
                "input": ["hs_source"],
            }
        ]
        for stage in d["message_passing"]["stages"]:
            for mp in stage["stage_mp"]:
                for se in mp["source_entities"]:
                    se["message"] = copy.deepcopy(msg)
        return real_parse(d, dims)

    P.parse_model_description = patched_parse
    try:
        make_step, params, opt_state, arrays, edges = bench.build_case(hs=hs)
    finally:
        P.parse_model_description = real_parse

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

    # node-table path (default)
    dt_node = timeit(jax.jit(make_step(jnp.bfloat16)))

    # per-edge path: disable the source-local predicate while the second
    # step traces (fresh function object -> fresh trace)
    orig = IR.is_source_local
    IR.is_source_local = lambda ops: False
    try:
        dt_edge = timeit(jax.jit(make_step(jnp.bfloat16)))
    finally:
        IR.is_source_local = orig

    print(
        f"mlp-message node-table path: {dt_node*1e3:.3f} ms/step "
        f"({edges/dt_node/1e6:.1f} Medges/s)"
    )
    print(
        f"mlp-message per-edge   path: {dt_edge*1e3:.3f} ms/step "
        f"({edges/dt_edge/1e6:.1f} Medges/s)"
    )
    print(f"speedup: {dt_edge/dt_node:.2f}x")


if __name__ == "__main__":
    main()
