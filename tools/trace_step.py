"""Where a cell's training step spends its device time.

Traces a steady window of train steps of a bench cell with jax.profiler,
then reduces the GPU plane of the trace (xplane.pb, read with
jax.profiler.ProfileData): device busy time (union of kernel intervals on
all streams), idle share of the window, kernel launches per step, and the
kernels that take the most time, by HLO op and by kind (the op name
without its ".N" suffix). Prints tables and one JSON line. GPU only.

XLA groups kernels into command buffers (CUDA graphs), which the trace
shows as one "command_buffer" event; run with
XLA_FLAGS=--xla_gpu_enable_command_buffer= to see the kernels inside.

Usage: python tools/trace_step.py --cell flagship [--steps 10] [--top 15]
"""

import argparse
import collections
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402


def _stat(event, name):
    """An event stat by name (the trace stores them as (name, value))."""
    for k, v in event.stats:
        if k == name:
            return v
    return None


def reduce_gpu_plane(xplane_path, steps, window_ns):
    """(busy_ns, launches, {op: device ns}) over the GPU planes."""
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    intervals, per_op, launches = [], collections.Counter(), 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                launches += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                op = _stat(ev, "hlo_op") or ev.name
                per_op[str(op)] += ev.duration_ns
    intervals.sort()
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy, launches, per_op


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="flagship")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU")
    make_step, params, opt_state, arrays, edges = bench.detail_cases()[
        args.cell]()
    arrays = jax.device_put(arrays)
    fn = jax.jit(make_step(jnp.dtype(args.dtype)))
    p, o, l = fn(params, opt_state, arrays)
    for _ in range(3):
        p, o, l = fn(p, o, arrays)
    jax.block_until_ready((p, o, l))
    out = tempfile.mkdtemp(prefix="trace_step_")
    jax.profiler.start_trace(out)
    t0 = time.perf_counter_ns()
    for _ in range(args.steps):
        p, o, l = fn(p, o, arrays)
    jax.block_until_ready((p, o, l))
    window = time.perf_counter_ns() - t0
    jax.profiler.stop_trace()
    pb = glob.glob(os.path.join(out, "**", "*.xplane.pb"), recursive=True)[0]
    busy, launches, per_op = reduce_gpu_plane(pb, args.steps, window)
    step_ms = window / args.steps / 1e6
    print(f"cell {args.cell} ({args.dtype}): {step_ms:.3f} ms/step traced "
          f"(profiler on), device busy {busy / args.steps / 1e6:.3f} ms/step, "
          f"idle share {1 - busy / window:.3f}, "
          f"{launches / args.steps:.0f} kernel launches/step")
    total = sum(per_op.values())
    by_kind = collections.Counter()
    for op, ns in per_op.items():
        by_kind[op.rsplit(".", 1)[0] if op.rsplit(".", 1)[-1].isdigit()
                else op] += ns
    for title, table in (("by op", per_op), ("by kind", by_kind)):
        print(f" {title}:")
        for op, ns in table.most_common(args.top):
            print(f"  {ns / args.steps / 1e3:9.1f} us/step "
                  f"{100 * ns / total:5.1f}%  {op[:100]}")
    print(json.dumps({
        "cell": args.cell, "dtype": args.dtype,
        "traced_ms_per_step": step_ms,
        "busy_ms_per_step": busy / args.steps / 1e6,
        "idle_share": 1 - busy / window,
        "launches_per_step": launches / args.steps,
        "top": [[op, ns / args.steps / 1e3]
                for op, ns in per_op.most_common(args.top)],
        "by_kind": [[op, ns / args.steps / 1e3]
                    for op, ns in by_kind.most_common(args.top)],
        "device_kind": jax.devices()[0].device_kind,
        "card": bench.card_info().splitlines()[0],
    }), flush=True)


if __name__ == "__main__":
    main()
