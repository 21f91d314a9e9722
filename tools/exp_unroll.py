"""Experiment: scan-unroll effects on the flagship training step .

Tries (a) current config, (b) inner time-scan unrolled, (c) outer
iteration-scan unrolled, measuring the step time like bench.py.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

from bench import build_case, time_step

import ignnition_tpu.nn.rnn as RNN
import ignnition_tpu.model.builder as B


def patch_unroll(time_unroll=1, iter_unroll=1):
    import jax.lax as lax

    orig_scan = lax.scan

    def masked_update_stacked(spec, params, xs, lengths, init_state):
        t_index = jnp.arange(xs.shape[0])
        if spec.cell_type == "GRU":

            def body(h, xt):
                x, t = xt
                valid = t < lengths
                h_new = RNN._gru_step(params, x, h)
                h = jnp.where(valid[:, None], h_new, h)
                return h, None

            final, _ = orig_scan(
                body, init_state, (xs, t_index), unroll=time_unroll
            )
            return final
        raise NotImplementedError

    RNN.masked_update_stacked = masked_update_stacked
    B.RNN.masked_update_stacked = masked_update_stacked

    if iter_unroll > 1:
        orig_apply_scan = jax.lax.scan

        def scan_unrolled(f, init, xs, length=None, **kw):
            kw.setdefault("unroll", iter_unroll)
            return orig_apply_scan(f, init, xs, length=length, **kw)

        B.jax.lax.scan = scan_unrolled


def main():
    make_step, params, opt_state, arrays, edges_per_step = build_case()

    dt0 = time_step(make_step(jnp.bfloat16), params, opt_state, arrays, iters=40)
    print(f"current:           {dt0*1e3:8.2f} ms  {edges_per_step/dt0/1e6:7.1f} Medges/s", flush=True)

    patch_unroll(time_unroll=8)
    make_step2 = build_case()[0]
    dt1 = time_step(make_step2(jnp.bfloat16), params, opt_state, arrays, iters=40)
    print(f"time unroll=8:     {dt1*1e3:8.2f} ms  {edges_per_step/dt1/1e6:7.1f} Medges/s", flush=True)

    patch_unroll(time_unroll=8, iter_unroll=8)
    make_step3 = build_case()[0]
    dt2 = time_step(make_step3(jnp.bfloat16), params, opt_state, arrays, iters=40)
    print(f"+ iter unroll=8:   {dt2*1e3:8.2f} ms  {edges_per_step/dt2/1e6:7.1f} Medges/s", flush=True)


if __name__ == "__main__":
    main()
