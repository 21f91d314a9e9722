"""Profile the flagship bf16 training step and print the top device ops.

Captures a jax profiler trace over a few steps, then parses the
trace-viewer JSON and aggregates device-lane op durations.
"""

import glob
import gzip
import json
import os
import tempfile
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np

from bench import build_case, detail_cases

TRACE_DIR = os.path.join(tempfile.gettempdir(), "ignnition_profile")


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="flagship",
                    help="flagship or a bench detail family "
                         "(attention/mlp_message/qsize/blocks_g4)")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()

    if args.family == "flagship":
        case = build_case()
    else:
        case = detail_cases()[args.family]()
    make_step, params, opt_state, arrays, _ = case
    arrays = jax.device_put(arrays)
    fn = jax.jit(make_step(jnp.bfloat16))
    p, o, l = fn(params, opt_state, arrays)
    float(l)

    os.system(f"rm -rf {TRACE_DIR}")
    jax.profiler.start_trace(TRACE_DIR)
    for _ in range(5):
        p, o, l = fn(p, o, arrays)
    float(l)
    jax.profiler.stop_trace()

    files = glob.glob(f"{TRACE_DIR}/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace.json.gz found; files:", glob.glob(f"{TRACE_DIR}/**/*", recursive=True))
        return
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)

    events = trace.get("traceEvents", [])
    # device planes only (the GPU's streams), skip python/host threads
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    dur_by_op = defaultdict(float)
    cnt_by_op = defaultdict(int)
    total = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        pname = pid_names.get(e.get("pid"), "")
        if not pname.startswith("/device:GPU"):
            continue
        name = e.get("name", "")
        d = e.get("dur", 0) / 1e3  # us -> ms
        dur_by_op[name] += d
        cnt_by_op[name] += 1
        total += d
    print(f"process lanes: {sorted(set(pid_names.values()))}")
    print(f"total device time over 5 steps: {total:.2f} ms ({total/5:.2f} ms/step)\n")
    top = sorted(dur_by_op.items(), key=lambda kv: -kv[1])[:args.top]
    for name, d in top:
        print(f"{d/5:8.3f} ms/step  x{cnt_by_op[name]//5:<4d} {name[:110]}")


if __name__ == "__main__":
    main()
