"""Micro-timings of the stage-1 hot ops at flagship shapes (bf16).

Pieces: table gather, permutation gather, sorted segment sum, masked GRU
scan fwd / fwd+bwd, full stage1 fwd / fwd+bwd.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ignnition_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax
import jax.numpy as jnp
import numpy as np


def time_fn(fn, args, iters=60):
    fn = jax.jit(fn)
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    N_LINK, N_PATH, L, D = 2048, 16384, 8, 32
    M = L * N_PATH
    rng = np.random.default_rng(0)
    dt = jnp.bfloat16

    table = jnp.asarray(rng.standard_normal((N_LINK, D)), dt)
    slice_src = jnp.asarray(rng.integers(0, N_LINK, (L, N_PATH)), jnp.int32)
    perm = jnp.asarray(rng.permutation(M), jnp.int32)
    big = jnp.asarray(rng.standard_normal((M, D)), dt)
    sort_ids = jnp.asarray(np.sort(rng.integers(0, N_LINK, M)), jnp.int32)
    h0 = jnp.asarray(rng.standard_normal((N_PATH, D)), dt)
    lens = jnp.full((N_PATH,), L, jnp.int32)

    from ignnition_tpu.ops import segment as seg
    from ignnition_tpu.nn import rnn as RNN
    from ignnition_tpu.frontend.ir import RNNSpec

    t = time_fn(lambda tb: tb[slice_src].sum(), (table,))
    print(f"table gather [L,P] from {N_LINK}:      {t*1e3:6.2f} ms")

    t = time_fn(lambda b: b[perm].sum(), (big,))
    print(f"perm gather {M}x{D}:                {t*1e3:6.2f} ms")

    t = time_fn(
        lambda b: seg.segment_sum(
            b, sort_ids, N_LINK, indices_are_sorted=True
        ).sum(),
        (big.astype(jnp.float32),),
    )
    print(f"sorted segsum {M}->{N_LINK}:           {t*1e3:6.2f} ms")

    spec = RNNSpec(name="u", cell_type="GRU")
    gp = {
        "kernel": jnp.asarray(rng.standard_normal((D, 3 * D)) * 0.1, dt),
        "recurrent_kernel": jnp.asarray(rng.standard_normal((D, 3 * D)) * 0.1, dt),
        "bias": jnp.zeros((2, 3 * D), dt),
    }
    xs = jnp.asarray(rng.standard_normal((L, N_PATH, D)), dt)

    def scan_fwd(p, x, h):
        return RNN.masked_update_stacked(spec, p, x, lens, h).astype(jnp.float32).sum()

    t = time_fn(scan_fwd, (gp, xs, h0))
    print(f"GRU masked scan fwd:               {t*1e3:6.2f} ms")
    t = time_fn(
        lambda p, x, h: jax.grad(scan_fwd, argnums=(0, 1, 2))(p, x, h), (gp, xs, h0)
    )
    print(f"GRU masked scan fwd+bwd:           {t*1e3:6.2f} ms")

    # full stage1 (gather + scan) fwd and fwd+bwd through gather_state_slices
    flat = np.asarray(slice_src).ravel()
    sp = np.argsort(flat, kind="stable").astype(np.int32)
    sids = flat[sp].astype(np.int32)
    srp = np.searchsorted(sids, np.arange(N_LINK + 1)).astype(np.int32)
    sp_j, sids_j, srp_j = map(jnp.asarray, (sp, sids, srp))

    def stage1(tb, h):
        x = seg.gather_state_slices(tb, slice_src, sp_j, sids_j, srp_j)
        return RNN.masked_update_stacked(spec, gp, x, lens, h).astype(jnp.float32).sum()

    t = time_fn(stage1, (table, h0))
    print(f"stage1 fwd (gather+scan):          {t*1e3:6.2f} ms")
    t = time_fn(lambda tb, h: jax.grad(stage1, argnums=(0, 1))(tb, h), (table, h0))
    print(f"stage1 fwd+bwd:                    {t*1e3:6.2f} ms")


if __name__ == "__main__":
    main()
