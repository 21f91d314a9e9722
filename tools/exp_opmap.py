"""Reconcile a family's measured step against its roofline, op by op.

Captures a profiler trace AND the optimized HLO of the same executable,
maps every device op (fusion.N / while.N / custom-call) to its HLO
metadata (op kind + repo source line), groups ops into step-anatomy
categories, and prints a table whose rows SUM to the measured step —
VERDICT r3 #7: every row either matches a roofline item or is flagged
overhead.

Usage: python -m tools.exp_opmap [--family flagship|attention|qsize|...]
"""

import argparse
import glob
import gzip
import json
import os
import tempfile
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

from bench import build_case, detail_cases

TRACE_DIR = os.path.join(tempfile.gettempdir(), "ignnition_opmap")
STEPS = 5


def hlo_metadata_map(hlo: str):
    """op result name -> (op_kind, op_name, source tag) from optimized HLO."""
    out = {}
    head = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\S+\s+([\w\-]+)\(")
    f_op = re.compile(r'op_name="([^"]*)"')
    f_file = re.compile(r'source_file="([^"]*)"')
    f_line = re.compile(r"source_line=(\d+)")
    for line in hlo.splitlines():
        m = head.match(line)
        if not m:
            continue
        name, kind = m.groups()
        op = f_op.search(line)
        sf = f_file.search(line)
        sl = f_line.search(line)
        tag = ""
        if sf:
            tag = os.path.basename(sf.group(1))
            if sl:
                tag += f":{sl.group(1)}"
        out[name] = (kind, op.group(1) if op else "", tag)
    return out


def categorize(name, kind, op_name, tag):
    """Step-anatomy category for one device op."""
    if tag.startswith("rnn.py"):
        return "rnn_scan (GRU updates)"
    if "attention_kernels" in tag:
        return "dense_attn (flash kernel)"
    if kind == "custom-call":
        return "custom calls (Triton kernels, library calls)"
    if "/gather" in op_name:
        if "transpose(" in op_name:
            return "gather_bwd (slice/windowed transposes)"
        return "gather_fwd (slice/edge gathers)"
    if "/scatter" in op_name:
        return "scatter (XLA fallback)"
    if "/dot_general" in op_name or kind in ("dot", "convolution"):
        if "segment.py" in tag:
            return "dense_incidence_matmul"
        return "mlp_readout_matmul"
    if "adam" in op_name or "/mul" in op_name and "opt" in op_name:
        return "optimizer"
    if kind in ("fusion",) and op_name == "":
        return "overhead (unattributed fusion)"
    return "elementwise/other fusions"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="flagship")
    ap.add_argument("--rows", type=int, default=14)
    args = ap.parse_args()

    if args.family == "flagship":
        case = build_case()
    elif args.family == "flagship_x4":
        case = build_case(n_links=8192, n_paths=65536)
    else:
        case = detail_cases()[args.family]()
    make_step, params, opt_state, arrays, edges = case
    arrays = jax.device_put(arrays)
    fn = jax.jit(make_step(jnp.bfloat16))
    p, o, l = fn(params, opt_state, arrays)
    float(l)
    hlo = fn.lower(params, opt_state, arrays).compile().as_text()
    meta_map = hlo_metadata_map(hlo)

    os.system(f"rm -rf {TRACE_DIR}")
    jax.profiler.start_trace(TRACE_DIR)
    for _ in range(STEPS):
        p, o, l = fn(p, o, arrays)
    float(l)
    jax.profiler.stop_trace()

    files = glob.glob(f"{TRACE_DIR}/**/*.trace.json.gz", recursive=True)
    with gzip.open(files[0], "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")

    cat_ms = defaultdict(float)
    cat_ops = defaultdict(set)
    total = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        # device planes only: the GPU's streams, not host threads
        if not pid_names.get(e.get("pid"), "").startswith("/device:GPU"):
            continue
        name = e.get("name", "")
        if name.startswith(("jit_", "while.")) or name.isdigit():
            # skip the whole-step wrapper, per-core lanes, and while-loop
            # ENVELOPES (their bodies appear as separate inner events —
            # counting both would double the RNN scans)
            continue
        d = e.get("dur", 0) / 1e3 / STEPS
        kind, op_name, tag = meta_map.get(name, ("", "", ""))
        cat = categorize(name, kind, op_name, tag)
        cat_ms[cat] += d
        if len(cat_ops[cat]) < 4:
            cat_ops[cat].add(f"{name}[{tag or op_name[:40]}]")
        total += d

    print(f"family={args.family}  sum of device ops: {total:.3f} ms/step "
          f"(events below sum to it)\n")
    for cat, ms in sorted(cat_ms.items(), key=lambda kv: -kv[1])[:args.rows]:
        ex = "; ".join(sorted(cat_ops[cat])[:3])
        print(f"{ms:8.3f} ms  {100*ms/total:5.1f}%  {cat}\n"
              f"              e.g. {ex[:150]}")


if __name__ == "__main__":
    main()
