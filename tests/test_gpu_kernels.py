"""The flash-GAT kernels compiled for the card (no interpreter) against the
XLA dense path as the float32 reference. Skips where JAX finds no GPU; run
on a GPU machine with JAX_PLATFORMS=cuda python -m pytest -m gpu tests/."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ignnition_tpu.ops import segment as seg

pytestmark = pytest.mark.gpu

# bf16: rounded inputs and bf16 dot operands; f32: IEEE f32 dots, sums in
# another order
_TOL = {jnp.bfloat16: 3e-2, jnp.float32: 1e-4}


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("shape", [(256, 2048, 32), (2048, 16384, 32)])
def test_flash_kernels_on_gpu(gpu, shape, dtype):
    n_dst, n_src, d = shape
    rng = np.random.default_rng(0)
    m = np.zeros((n_dst, n_src), np.int8)
    for s in range(n_src):
        np.add.at(m[:, s], rng.integers(0, n_dst, 8), 1)
    m = jnp.asarray(m)
    args = [jnp.asarray(rng.standard_normal(n), dtype)
            for n in (n_src, n_dst)]
    args.append(jnp.asarray(rng.standard_normal((n_src, d)), dtype))
    ct = jnp.asarray(rng.standard_normal((n_dst, d)), jnp.float32)

    def fwd_bwd(fn, a, b, c):
        def loss(a, b, c):
            out = fn(a, b, c, m)
            return jnp.sum(out.astype(jnp.float32) * ct), out

        (_, out), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(a, b, c)
        return (out,) + g

    got = jax.jit(functools.partial(
        fwd_bwd, seg._flash_masked_softmax_matmul))(*args)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(functools.partial(
            fwd_bwd, seg._dense_masked_softmax_matmul))(
            *[a.astype(jnp.float32) for a in args])
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.all(np.isfinite(g))
        assert np.abs(g - w).max() <= _TOL[dtype] * np.abs(w).max()


def test_attention_dispatch_picks_flash_on_gpu(gpu):
    """On the card, bf16 tables of eligible shape take the flash kernels."""
    m = jnp.zeros((2048, 16384), jnp.int8)
    assert seg.use_flash_attn(m, jnp.zeros((16384, 32), jnp.bfloat16))
    assert not seg.use_flash_attn(m, jnp.zeros((16384, 32), jnp.float32))
