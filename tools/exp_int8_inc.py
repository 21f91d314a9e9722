"""int8 incidence storage probe for the dense sum paths (VERDICT r4 #6).

The dense sum/convolution lowerings stream a bf16 multiplicity matrix per
pass (segment.py direct_segment_sum_dense; qsize's two dense stages read
2.15 GB/step of it). The entries are tiny non-negative integers, so int8
storage halves the dominant HBM stream IF XLA fuses the int8->bf16
convert into the matmul's operand load instead of materializing a bf16
copy. This measures exactly that, in isolation, fwd+bwd (the backward
reads M again for M^T @ ct), chained in-jit (exp_segsum_floor timing
conventions).

Usage: python -m tools.exp_int8_inc
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp


def build(n_dst, n_src, D, store_dtype, M=20):
    rng = np.random.default_rng(0)
    # ~8 edges/dst-row like the flagship incidence, multiplicities 0..3
    mat = (rng.random((n_dst, n_src)) < 8.0 / n_src).astype(np.int8)
    mat = mat * rng.integers(1, 4, mat.shape).astype(np.int8)
    m_dev = jnp.asarray(mat, store_dtype)
    s = jnp.asarray(rng.standard_normal((n_src, D)), jnp.bfloat16)

    def f(m, s):
        out = jax.lax.dot_general(
            m.astype(jnp.bfloat16), s, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return jnp.sum(out)

    @jax.jit
    def step(m, s):
        def body(carry, _):
            # the carry feeds the dot so the loop body is NOT invariant
            l, gs = jax.value_and_grad(f, argnums=1)(m, carry)
            return gs.astype(carry.dtype), l
        g, ls = jax.lax.scan(body, s, None, length=M)
        return jnp.sum(ls)

    step.M = M
    return step, m_dev, s


def time_it(step, m, s, trials=5, target_s=0.05):
    float(step(m, s))

    def trial(iters):
        t0 = time.time()
        float(step(m, s))
        base = time.time() - t0
        t0 = time.time()
        acc = None
        for _ in range(iters):
            acc = step(m, s)
        float(acc)
        return max(time.time() - t0 - base, 1e-9) / (iters - 1) / step.M

    est = trial(5) * step.M
    iters = int(min(max(target_s / max(est, 1e-7), 5), 300))
    return min(trial(iters) for _ in range(trials))


def main():
    shapes = [(2048, 16384, 32), (16384, 2048, 32)]
    for n_dst, n_src, D in shapes:
        rows = {}
        for dt in (jnp.bfloat16, jnp.int8):
            step, m, s = build(n_dst, n_src, D, dt)
            rows[dt.__name__] = time_it(step, m, s)
        b, i8 = rows["bfloat16"], rows["int8"]
        mb = n_dst * n_src * 2 / 1e6
        print(f"[{n_dst},{n_src}]x[{n_src},{D}] (bf16 M = {mb:.0f} MB): "
              f"bf16 {b*1e3:.3f} ms  int8 {i8*1e3:.3f} ms  "
              f"({b/i8:.2f}x {'WIN' if i8 < b*0.97 else 'no win'})",
              flush=True)


if __name__ == "__main__":
    main()
