"""Experiment: unroll the RNN time axis inside the (already python-unrolled)
MP iterations — the flagship's last remaining while loop.

Round-4 opmap attribution: "RNN scans" cost 2.25 ms/step (30% of the
flagship step), ~10x the pure HBM traffic of the 64 small scan steps —
i.e. while-loop/fusion-boundary overhead, the same disease the iteration
unroll cured in round 3. Variants measured (each a distinct function
object, so no stale-trace hazard):

  a) current: lax.scan over time, jax.checkpoint body (gate remat)
  b) lax.scan(unroll=L): one while iteration, body repeated L times
  c) python loop over t, each step wrapped in jax.checkpoint
  d) python loop, no checkpoint (AD saves gates per step — measures
     whether remat still pays once the loop is unrolled)

Not yet measured on the GPU.
"""

import os
import sys
import functools

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp

import ignnition_tpu.nn.rnn as RNN
from bench import build_case, time_step

_orig = RNN.masked_update_stacked


def scan_unrolled(spec, params, xs, lengths, init_state):
    assert spec.cell_type == "GRU"
    t_index = jnp.arange(xs.shape[0])

    @jax.checkpoint
    def body(h, xt):
        x, t = xt
        valid = t < lengths
        h_new = RNN._gru_step(params, x, h)
        return jnp.where(valid[:, None], h_new, h), None

    final, _ = jax.lax.scan(
        body, init_state, (xs, t_index), unroll=xs.shape[0]
    )
    return final


def python_loop(spec, params, xs, lengths, init_state, remat=True):
    assert spec.cell_type == "GRU"

    def one(h, x, valid):
        h_new = RNN._gru_step(params, x, h)
        return jnp.where(valid[:, None], h_new, h)

    step = jax.checkpoint(one) if remat else one
    h = init_state
    for t in range(xs.shape[0]):
        h = step(h, xs[t], t < lengths)
    return h


def run(name, fn):
    RNN.masked_update_stacked = fn
    try:
        make_step, params, opt_state, arrays, eps = build_case()
        dt = time_step(make_step(jnp.bfloat16), params, opt_state, arrays, iters=40)
        print(f"{name:28s} {dt*1e3:8.2f} ms  {eps/dt/1e6:7.1f} Medges/s", flush=True)
    finally:
        RNN.masked_update_stacked = _orig


if __name__ == "__main__":
    run("a) scan+remat (current)", _orig)
    run("b) scan(unroll=L)+remat", scan_unrolled)
    run("c) python loop + remat", python_loop)
    run("d) python loop, no remat",
        functools.partial(python_loop, remat=False))
