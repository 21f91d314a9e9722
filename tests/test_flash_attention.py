"""Flash-GAT Pallas kernels (ops/pallas/attention_kernels.py, Triton route)
vs the XLA dense attention path — in Pallas's interpreter on the CPU. The
compiled kernels are checked against the same reference on the GPU by
chip_smoke.py; tests/test_dense_inc.py covers the XLA path itself."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ignnition_tpu.ops import segment as seg
from ignnition_tpu.ops.pallas.attention_kernels import (
    FlashTiles, flash_gat_backward, flash_gat_forward, pick_tiles,
)

# (n_dst, n_src, d): one tile, several tiles with split loop ranges, and a
# non-power-of-two padded size
SHAPES = [(32, 128, 16), (64, 512, 32), (48, 384, 16)]


def _case(n_dst, n_src, d=16, seed=0, density=0.05, inc_dtype=jnp.int8,
          dtype=jnp.float32, pad=0):
    rng = np.random.default_rng(seed)
    m = (rng.random((n_dst, n_src)) < density).astype(np.float32)
    m *= rng.integers(1, 4, (n_dst, n_src))  # multiplicities up to 3
    m[0] = 0.0  # an isolated destination: out must be exactly 0
    if pad:
        m[-pad:] = 0.0  # padding destination rows
        m[:, -pad:] = 0.0  # padding source columns
    m = jnp.asarray(m, inc_dtype)
    ssrc = jnp.asarray(rng.standard_normal(n_src), dtype)
    sdst = jnp.asarray(rng.standard_normal(n_dst), dtype)
    x = jnp.asarray(rng.standard_normal((n_src, d)), dtype)
    ct = jnp.asarray(rng.standard_normal((n_dst, d)), jnp.float32)
    return ssrc, sdst, x, m, ct


def _f32(*a):
    return tuple(jnp.asarray(v, jnp.float32) for v in a)


# bf16 inputs and outputs: the reference runs in f32 on the same rounded
# inputs, so the kernels differ by bf16 rounding of z, a and the output
# (~2^-8 relative); f32 runs IEEE f32 dots on both sides
_TOL = {jnp.float32: dict(rtol=2e-4, atol=2e-5),
        jnp.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("inc_dtype", [jnp.int8, jnp.bfloat16])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_dense_path(shape, dtype, inc_dtype):
    ssrc, sdst, x, m, ct = _case(*shape, inc_dtype=inc_dtype, dtype=dtype,
                                 pad=8)
    stab = seg._flash_stab(ssrc, sdst)
    out, den = flash_gat_forward(ssrc, sdst, x, m, stab, interpret=True)
    # f32 out: the custom VJP casts it to x's dtype and keeps it for srow
    assert out.dtype == jnp.float32 and out.shape == (shape[0], shape[2])
    with jax.default_matmul_precision("highest"):
        ref = seg._dense_masked_softmax_matmul(*_f32(ssrc, sdst, x), m)
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref),
                               **_TOL[dtype])
    # the isolated and padding destinations aggregate to exactly zero
    np.testing.assert_array_equal(np.asarray(out[0], np.float32), 0.0)
    np.testing.assert_array_equal(np.asarray(out[-8:], np.float32), 0.0)
    # den is the softmax denominator in the stab frame: rows with support
    # are strictly positive
    has_support = np.asarray(jnp.sum(m.astype(jnp.float32), axis=1)) > 0
    assert np.all(np.asarray(den)[has_support] > 0.0)


@pytest.mark.parametrize("inc_dtype", [jnp.int8, jnp.bfloat16])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_dense_path_grads(shape, dtype, inc_dtype):
    """Gradients of the flash custom VJP (all three kernels) vs autodiff of
    the XLA dense path."""
    ssrc, sdst, x, m, ct = _case(*shape, seed=3, inc_dtype=inc_dtype,
                                 dtype=dtype, pad=8)

    def loss(fn, a, b, c):
        return jnp.sum(fn(a, b, c, m).astype(jnp.float32) * ct)

    flash = functools.partial(seg._flash_masked_softmax_matmul,
                              interpret=True)
    g_flash = jax.grad(functools.partial(loss, flash), argnums=(0, 1, 2))(
        ssrc, sdst, x)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(
            functools.partial(loss, seg._dense_masked_softmax_matmul),
            argnums=(0, 1, 2),
        )(*_f32(ssrc, sdst, x))
    for got, want in zip(g_flash, g_ref):
        assert got.dtype == dtype
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        tol = _TOL[dtype]
        np.testing.assert_allclose(np.asarray(got, np.float32), want,
                                   rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.parametrize("score_scale", [1.0, 0.01])
def test_bf16_gradients_as_accurate_as_xla(score_scale):
    """Regression: the softmax-VJP statistic srow = ct.out was taken from
    the bf16-rounded output, which shifts every (da - srow) by out's
    rounding. With messages that share a component (as hidden states do)
    the score gradients are small differences, and d_sdst lost ~3x the
    accuracy of XLA's bf16 path (40% vs 8.5% on an attention model's
    score weights). From the f32 output, each flash gradient is at least
    as close to the f32 reference as XLA's bf16 path is."""
    rng = np.random.default_rng(0)
    n_dst, n_src, d = 64, 512, 32
    m = jnp.asarray((rng.random((n_dst, n_src)) < 0.05)
                    * rng.integers(1, 3, (n_dst, n_src)), jnp.int8)
    bf = jnp.bfloat16
    ssrc = jnp.asarray(score_scale * rng.standard_normal(n_src), bf)
    sdst = jnp.asarray(score_scale * rng.standard_normal(n_dst), bf)
    x = jnp.asarray(3.0 + rng.standard_normal((n_src, d)), bf)
    ct = jnp.asarray(rng.standard_normal((n_dst, d)), bf).astype(jnp.float32)

    def grads(fn, *args):
        return jax.grad(
            lambda a, b, c: jnp.sum(fn(a, b, c, m).astype(jnp.float32) * ct),
            argnums=(0, 1, 2),
        )(*args)

    flash = grads(functools.partial(seg._flash_masked_softmax_matmul,
                                    interpret=True), ssrc, sdst, x)
    xla = grads(seg._dense_masked_softmax_matmul, ssrc, sdst, x)
    with jax.default_matmul_precision("highest"):
        ref = grads(seg._dense_masked_softmax_matmul, *_f32(ssrc, sdst, x))
    for name, f, xl, r in zip(("d_ssrc", "d_sdst", "d_table"), flash, xla,
                              ref):
        r = np.asarray(r, np.float64)
        err = lambda g: np.linalg.norm(np.asarray(g, np.float64) - r) / (
            np.linalg.norm(r))
        assert err(f) <= err(xl), (name, err(f), err(xl))


def test_backward_kernels_match_dense_path_grads():
    """flash_gat_backward's raw outputs (f32 partial sums over split ranges)
    against autodiff of the XLA dense path."""
    ssrc, sdst, x, m, ct = _case(64, 512, 32, seed=4)
    stab = seg._flash_stab(ssrc, sdst)
    out, den = flash_gat_forward(ssrc, sdst, x, m, stab, interpret=True)
    srow = jnp.sum(ct * out, axis=1)
    d_ssrc, d_sdst, d_table = flash_gat_backward(
        ssrc, sdst, x, m, stab, den, ct, srow, interpret=True
    )

    def loss(a, b, c):
        return jnp.sum(seg._dense_masked_softmax_matmul(a, b, c, m) * ct)

    g = jax.grad(loss, argnums=(0, 1, 2))(ssrc, sdst, x)
    for got, want in zip((d_ssrc, d_sdst, d_table), g):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


def test_score_outliers_do_not_underflow_rows():
    """Regression: a +60-nat sdst outlier on ONE row plus a +60-nat ssrc
    outlier outside another row's support used to push a GLOBAL stab bound
    past the exp budget and zero that row's output; the per-row bound
    lrelu(sdst[d] + max ssrc) keeps every row exact vs the per-row-max XLA
    dense path."""
    rng = np.random.default_rng(11)
    n_dst, n_src, d = 16, 128, 16
    m = np.zeros((n_dst, n_src), np.float32)
    # row 0 connects only to low-score sources; row 1 owns the outliers
    m[0, 1:9] = 1.0
    m[1, 0] = 1.0
    for i in range(2, n_dst):
        m[i, rng.integers(1, n_src, 6)] = 1.0
    m = jnp.asarray(m, jnp.int8)
    ssrc = np.asarray(rng.standard_normal(n_src), np.float32)
    ssrc[0] = 60.0  # outlier source, only in row 1's support
    sdst = np.asarray(rng.standard_normal(n_dst), np.float32)
    sdst[1] = 60.0  # outlier destination
    ssrc, sdst = jnp.asarray(ssrc), jnp.asarray(sdst)
    x = jnp.asarray(rng.standard_normal((n_src, d)), jnp.float32)

    stab = seg._flash_stab(ssrc, sdst)
    out, den = flash_gat_forward(ssrc, sdst, x, m, stab, interpret=True)
    ref = seg._dense_masked_softmax_matmul(ssrc, sdst, x, m)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    assert float(jnp.min(den)) > 0.0  # no row underflowed to zero support


def test_pick_tiles():
    # flagship: the measured tiles, ~1024 / 2048 blocks
    t = pick_tiles(2048, 16384, 32)
    assert t == FlashTiles(64, 128, 32, 4, 64, 32, 8, 4)
    assert (2048 // t.td) * t.split == 1024
    assert (16384 // t.src_ts) * t.src_split == 2048
    # splits always cover whole loop steps
    for n_dst, n_src, d in SHAPES + [(2048, 16384, 32), (4096, 2048, 64)]:
        t = pick_tiles(n_dst, n_src, d)
        assert n_src % (t.ts * t.split) == 0 and n_dst % t.td == 0
        assert n_dst % (t.src_td * t.src_split) == 0 and n_src % t.src_ts == 0
    assert pick_tiles(2048, 16384, 128).ts == 64  # wide tables: smaller step
    assert pick_tiles(40, 384, 16) is None  # dst not a multiple of 16
    assert pick_tiles(64, 100, 16) is None  # src not a multiple of 16
    assert pick_tiles(64, 256, 8) is None  # Triton dots need width >= 16
    assert pick_tiles(64, 256, 48) is None  # ... and a power of two


@pytest.mark.parametrize(
    "shape,dtype,gpu,want",
    [
        ((64, 256, 32), jnp.bfloat16, False, False),  # CPU: never
        ((64, 256, 32), jnp.bfloat16, True, True),
        ((64, 256, 32), jnp.float32, True, False),  # f32: XLA is faster
        ((64, 256, 8), jnp.bfloat16, True, False),  # width below 16
        ((40, 256, 32), jnp.bfloat16, True, False),  # untileable rows
    ],
)
def test_dispatch_gates(monkeypatch, shape, dtype, gpu, want):
    """use_flash_attn: the kernels run where ops/platform.py says kernels
    run, for bf16 tables of eligible shape only."""
    n_dst, n_src, d = shape
    if gpu:
        monkeypatch.setattr(seg, "kernels_enabled", lambda: True)
    m = jnp.zeros((n_dst, n_src), jnp.int8)
    assert seg.use_flash_attn(m, jnp.zeros((n_src, d), dtype)) is want


def test_kernels_enabled_only_on_gpu(monkeypatch):
    import ignnition_tpu.ops.platform as platform

    assert not platform.kernels_enabled()  # the tests run on the CPU
    for backend, want in (("gpu", True), ("cpu", False), ("rocm", False)):
        monkeypatch.setattr(platform.jax, "default_backend", lambda: backend)
        assert platform.kernels_enabled() is want


def test_dense_attention_aggregate_takes_flash_path(monkeypatch):
    """With kernels enabled, dense_attention_aggregate routes bf16 tables
    through the flash custom VJP (run here in the interpreter) and matches
    the XLA dense path in values and in gradients of every parameter."""
    rng = np.random.default_rng(7)
    n_dst, n_src, d = 32, 256, 16
    m = jnp.asarray(
        (rng.random((n_dst, n_src)) < 0.08) * rng.integers(1, 3, (n_dst, n_src)),
        jnp.int8,
    )
    bf = jnp.bfloat16
    msg = jnp.asarray(rng.standard_normal((n_src, d)), bf)
    dst = jnp.asarray(rng.standard_normal((n_dst, d)), bf)
    k1 = jnp.asarray(rng.standard_normal((d, d)) / 4, bf)
    k2 = jnp.asarray(rng.standard_normal((d, d)) / 4, bf)
    att = jnp.asarray(rng.standard_normal((2 * d, 1)) / 4, bf)
    ct = jnp.asarray(rng.standard_normal((n_dst, d)), jnp.float32)

    def loss(*p):
        out = seg.dense_attention_aggregate(p[0], p[1], m, *p[2:])
        return jnp.sum(out.astype(jnp.float32) * ct)

    args = (msg, dst, k1, k2, att)
    want = loss(*args), jax.grad(loss, argnums=range(5))(*args)
    calls = []
    real = seg._flash_masked_softmax_matmul

    def flash(*a):
        calls.append(1)
        return real(*a, True)

    monkeypatch.setattr(seg, "kernels_enabled", lambda: True)
    monkeypatch.setattr(seg, "_flash_masked_softmax_matmul", flash)
    got = loss(*args), jax.grad(loss, argnums=range(5))(*args)
    assert calls
    # bf16 on both sides: bf16 rounding of the attention tiles and outputs
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=2e-2)
    for a, b in zip(got[1], want[1]):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=5e-2,
                                   atol=3e-2 * np.abs(b).max())


def test_factored_backward_adds_no_bf16_error():
    """Round-4 review concern: the factored backward's difference-of-
    near-equal-matmuls form could amplify bf16 quantization where the
    legacy elementwise (da - s_row) form would not. Measured: the two are
    EQUAL to ~1e-3 relative in bf16 even in the worst (near-uniform
    attention) regime — the bf16 error both share comes from the quantized
    score inputs upstream, not the backward's algebra."""
    import os

    rng = np.random.default_rng(2)
    n_dst, n_src, d = 64, 256, 16
    m = jnp.asarray(
        (rng.random((n_dst, n_src)) < 0.05).astype(np.float32), jnp.bfloat16
    )
    # near-uniform: tiny scores make (da - s_row) maximally cancellation-prone
    ssrc = jnp.asarray(0.01 * rng.standard_normal(n_src), jnp.bfloat16)
    sdst = jnp.asarray(0.01 * rng.standard_normal(n_dst), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((n_src, d)), jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal((n_dst, d)), jnp.float32)

    def grads(a, b, c):
        return jax.grad(
            lambda s1, s2, xx: jnp.sum(
                seg._dense_masked_softmax_matmul(s1, s2, xx, m).astype(
                    jnp.float32
                ) * ct
            ),
            argnums=(0, 1, 2),
        )(a, b, c)

    g_fac = grads(ssrc, sdst, x)
    os.environ["IGNNITION_TPU_DENSE_ATTN_BWD"] = "legacy"
    try:
        g_leg = grads(ssrc, sdst, x)
    finally:
        del os.environ["IGNNITION_TPU_DENSE_ATTN_BWD"]
    for a, b in zip(g_fac, g_leg):
        af, bf = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(bf).max(), 1e-9)
        # within a couple of bf16 output ulps — NOT the orders-of-magnitude
        # amplification the cancellation scenario predicted
        assert np.abs(af - bf).max() / scale < 6e-3


def test_legacy_and_factored_backward_agree():
    """The round-4 matmul-factored XLA backward equals the materializing
    legacy backward (IGNNITION_TPU_DENSE_ATTN_BWD=legacy A/B toggle)."""
    ssrc, sdst, x, m, ct = _case(48, 256, seed=5)

    def loss(ssrc, sdst, x):
        return jnp.sum(seg._dense_masked_softmax_matmul(ssrc, sdst, x, m) * ct)

    g_new = jax.grad(loss, argnums=(0, 1, 2))(ssrc, sdst, x)
    res = (ssrc, sdst, x, m)
    ct_full = jnp.asarray(np.asarray(ct), jnp.float32)
    g_leg = seg._dmsm_bwd_legacy(res, ct_full)
    for a, b in zip(g_new, g_leg[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_kernels_lower_for_cuda(dtype):
    """The three kernels pass the Pallas Triton lowering for the CUDA
    platform (run here on the CPU; compiling and running them needs the
    card — tests/test_gpu_kernels.py)."""
    ssrc, sdst, x, m, ct = _case(64, 512, 32, dtype=dtype)

    def loss(a, b, c):
        out = seg._flash_masked_softmax_matmul(a, b, c, m)
        return jnp.sum(out.astype(jnp.float32) * ct)

    text = jax.jit(jax.grad(loss, argnums=(0, 1, 2))).trace(
        ssrc, sdst, x
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") >= 3
    for name in ("flash_gat_fwd", "flash_gat_bwd_dst", "flash_gat_bwd_src"):
        assert name in text
