"""Dump the optimized HLO of the flagship train step and print the
definition of named fusions (to identify profiler hot spots)."""

import os
import tempfile
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

from bench import build_case


def main():
    names = sys.argv[1:] or ["fusion.238"]
    make_step, params, opt_state, arrays, _ = build_case()
    fn = jax.jit(make_step(jnp.bfloat16))
    lowered = fn.lower(params, opt_state, arrays)
    compiled = lowered.compile()
    hlo = compiled.as_text()
    path = os.path.join(tempfile.gettempdir(), "flagship_hlo.txt")
    with open(path, "w") as f:
        f.write(hlo)
    print(f"HLO written ({len(hlo)} bytes) to {path}")
    for name in names:
        # print the computation a fusion calls, plus the fusion instruction
        for m in re.finditer(rf"^\s*%?{re.escape(name)} = .*$", hlo, re.M):
            print("\n== instr ==\n", m.group(0)[:2000])


if __name__ == "__main__":
    main()
