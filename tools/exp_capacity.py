"""Map the single-chip HBM capacity edge of the flagship model
(VERDICT r4 #5): grow the single-graph batch xN until allocation fails,
record the max-edges-per-chip point, and validate the analytic HBM
estimator (utils/memory.py) against the measured OOM boundary.

Usage: python -m tools.exp_capacity [--xs 8,16,24,32,48]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--xs", default="8,16,24,32,48")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import build_case, time_step
    from ignnition_tpu.utils.memory import estimate_train_hbm

    results = []
    for x in [int(s) for s in args.xs.split(",")]:
        n_links, n_paths = 2048 * x, 16384 * x
        try:
            make_step, params, opt_state, arrays, edges = build_case(
                n_links=n_links, n_paths=n_paths
            )
            est = estimate_train_hbm(
                make_step.model_ir, make_step.meta,
                batch_bytes=sum(v.nbytes for v in arrays.values()),
            )
            dt = time_step(
                make_step(jnp.bfloat16), params, opt_state, arrays, iters=5
            )
            row = {
                "x": x, "edges_per_step": edges,
                "ms_per_step": round(dt * 1e3, 2),
                "medges_s": round(edges / dt / 1e6, 1),
                "est_hbm_gb": round(est["total_bytes"] / 1e9, 2),
                "ok": True,
            }
        except Exception as e:
            msg = str(e)
            oom = "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg or \
                "exceeds the amount" in msg or "OOM" in msg.upper()
            try:
                est_gb = round(est["total_bytes"] / 1e9, 2)
            except Exception:
                est_gb = None
            row = {
                "x": x, "ok": False, "oom": oom,
                "est_hbm_gb": est_gb,
                "error": f"{type(e).__name__}: {msg[:160]}",
            }
        results.append(row)
        print(row, flush=True)
        if not row["ok"]:
            break
    print("\nsummary:")
    last_ok = [r for r in results if r.get("ok")]
    if last_ok:
        r = last_ok[-1]
        print(f"largest fitting: x{r['x']} = {r['edges_per_step']//8} real "
              f"edges/graph-step pair, est {r['est_hbm_gb']} GB, "
              f"{r['medges_s']} Medges/s")
    failed = [r for r in results if not r.get("ok")]
    if failed:
        print(f"first failure: x{failed[0]['x']} (oom={failed[0]['oom']}) "
              f"est {failed[0]['est_hbm_gb']} GB")


if __name__ == "__main__":
    main()
