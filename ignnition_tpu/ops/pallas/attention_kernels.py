"""Flash-style Pallas kernels (Triton route) for the dense GAT attention
aggregation.

The XLA dense path (ops/segment.py `_dense_masked_softmax_matmul`) has to
materialize the [n_dst, n_src] attention matrix in device memory for its
matmuls — several full passes over a 33.5M-entry matrix per message-passing
iteration at flagship scale. The op sits far below the card's
flop-per-byte balance point, so bytes are the cost. These kernels read the
incidence matrix once per kernel and keep every [TD, TS] score/attention
tile in registers (flash-attention structure, adapted to GATv1 scores over
a multiplicity-weighted support):

  forward   grid over destination tiles; a loop over source tiles
            accumulates  z @ x  and the row sum of z, with
            z = m * exp(LeakyReLU(sdst + ssrc) - stab) computed per tile.
            out = acc / den; den is saved for the backward.
  backward  split like the library's Triton flash attention (dq apart from
            dk/dv), because blocks run in parallel and cannot share an
            accumulator:
              dst kernel  grid over destination tiles, loop over source
                          tiles:  d_sdst[i] = sum_s w[i,s](da[i,s]-srow[i])
              src kernel  grid over source tiles, loop over destination
                          tiles:  d_table[s] = sum_i a[i,s] ct[i]
                                  d_ssrc[s]  = sum_i w[i,s](da[i,s]-srow[i])
            with a = z/den, da = ct @ x^T per tile, w = a * LeakyReLU'(pre)
            and srow[i] = ct[i].out[i] (the flash softmax-VJP statistic).

Stabilization uses the PER-ROW score bound lrelu(sdst[d] + max ssrc)
(monotonicity — computable from the per-node score vectors alone): exact in
the sdst spread, and only an ssrc spread past the ~88-nat exp budget can
underflow a row — the same exposure `sorted_segment_softmax` documents as
exact for GAT score ranges; exp(e - stab) <= 1 never overflows.

Eligibility (`pick_tiles`): Triton's dot needs every operand dimension
>= 16 and power-of-two tiles, so D must be 16, 32, 64 or 128 and both node
counts multiples of 16. ops/segment.py runs the XLA dense path for any
other shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_SLOPE = 0.2  # LeakyReLU negative slope (reference a_c.py GAT scores)
_WIDTHS = (16, 32, 64, 128)


class FlashTiles(NamedTuple):
    """Tiles of the three kernels.

    Forward and dst-backward: [td, ts] tiles, a grid of (n_dst / td)
    destination tiles by `split` source ranges (each block loops over its
    range in steps of ts; XLA sums the `split` partials), `warps` warps.
    Src-backward: the same with the roles swapped — [src_td, src_ts] tiles,
    (n_src / src_ts) source tiles by `src_split` destination ranges."""

    td: int
    ts: int
    split: int
    warps: int
    src_ts: int
    src_td: int
    src_split: int
    src_warps: int


def _pick(n, cands):
    for c in cands:
        if n % c == 0:
            return c
    return None


def _split(n_tiles: int, n: int, step: int, blocks: int) -> int:
    """Largest power-of-two split of an n-long range into chunks that are a
    whole number of `step`s, keeping the grid at <= `blocks` blocks."""
    k = 1
    while n_tiles * k * 2 <= blocks and n % (k * 2 * step) == 0:
        k *= 2
    return k


def pick_tiles(n_dst: int, n_src: int, d: int) -> Optional[FlashTiles]:
    """Power-of-two tiles for an [n_dst, n_src] matrix and width-d tables,
    or None when the shape is ineligible.

    Small destination counts (2048 at flagship size) give too few tiles to
    fill the card, so each kernel also splits its loop dimension across
    blocks and XLA adds the partial sums (a few MB). The tile shapes and
    grid sizes (about 1024 forward / dst-backward and 2048 src-backward
    blocks) are the fastest of a sweep on an H100 at [2048, 16384], D=32,
    bf16 (PERF.md)."""
    if d not in _WIDTHS:
        return None
    td = _pick(n_dst, (64, 32, 16))
    ts = _pick(n_src, (128, 64, 32, 16) if d <= 64 else (64, 32, 16))
    src_ts = _pick(n_src, (64, 32, 16))
    src_td = _pick(n_dst, (32, 16))
    if None in (td, ts, src_ts, src_td):
        return None
    return FlashTiles(
        td, ts, _split(n_dst // td, n_src, ts, 1024), 4,
        src_ts, src_td, _split(n_src // src_ts, n_dst, src_td, 2048), 4,
    )


def _tile_z(sdst, ssrc, m, stab):
    """z = m * exp(lrelu(sdst + ssrc) - stab) for one [TD, TS] tile, f32,
    plus the pre-activation (its sign picks the LeakyReLU slope).

    stab is the per-row bound lrelu(sdst + max ssrc) >= every e in the row,
    so exp(e - stab) <= 1 stays finite and the absent-edge mask needs no
    select: the m multiply alone zeroes it (no inf * 0 hazard)."""
    pre = sdst[:, None] + ssrc[None, :]
    e = jnp.maximum(pre, _SLOPE * pre)  # lrelu, branch-free (slope < 1)
    return jnp.exp(e - stab[:, None]) * m.astype(jnp.float32), pre


def _dot(a, b, contract, dtype):
    """The repo's dense-path precision policy (ops/segment._dot): f32 inputs
    run HIGHEST, which the Triton route lowers to IEEE f32 instead of TF32;
    bf16 runs a single DEFAULT pass. f32 accumulation either way."""
    prec = (
        jax.lax.Precision.HIGHEST
        if dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    return jax.lax.dot_general(
        a, b, (contract, ((), ())), precision=prec,
        preferred_element_type=jnp.float32,
    )


def _call(kernel, name, grid, in_specs, out_specs, out_shape, warps,
          interpret):
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=warps, num_stages=2
        ),
        interpret=interpret,
        name=name,
    )


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _fwd_kernel(stab_ref, sdst_ref, ssrc_ref, x_ref, m_ref, acc_ref, den_ref,
                *, ts):
    td, chunk = m_ref.shape
    d = x_ref.shape[1]
    sdst = sdst_ref[...]
    stab = stab_ref[...]

    def body(j, carry):
        acc, den = carry
        cols = pl.ds(j * ts, ts)
        z, _ = _tile_z(sdst, ssrc_ref[cols], m_ref[:, cols], stab)
        acc = acc + _dot(z.astype(x_ref.dtype), x_ref[cols, :],
                         ((1,), (0,)), x_ref.dtype)
        return acc, den + jnp.sum(z, axis=1)

    acc, den = jax.lax.fori_loop(
        0, chunk // ts, body,
        (jnp.zeros((td, d), jnp.float32), jnp.zeros((td,), jnp.float32)),
    )
    acc_ref[...] = acc
    den_ref[...] = den


def _fwd_partials(ssrc, sdst, x, m, stab, t, interpret):
    n_dst, n_src = m.shape
    d = x.shape[1]
    chunk = n_src // t.split
    row = pl.BlockSpec((t.td,), lambda i, k: (i,))
    return _call(
        functools.partial(_fwd_kernel, ts=t.ts), "flash_gat_fwd",
        (n_dst // t.td, t.split),
        [
            row,
            row,
            pl.BlockSpec((chunk,), lambda i, k: (k,)),
            pl.BlockSpec((chunk, d), lambda i, k: (k, 0)),
            pl.BlockSpec((t.td, chunk), lambda i, k: (i, k)),
        ],
        [
            pl.BlockSpec((None, t.td, d), lambda i, k: (k, i, 0)),
            pl.BlockSpec((None, t.td), lambda i, k: (k, i)),
        ],
        [
            jax.ShapeDtypeStruct((t.split, n_dst, d), jnp.float32),
            jax.ShapeDtypeStruct((t.split, n_dst), jnp.float32),
        ],
        t.warps, interpret,
    )(_f32(stab), _f32(sdst), _f32(ssrc), x, m)


@functools.partial(jax.jit, static_argnames=("interpret", "tiles"))
def flash_gat_forward(ssrc, sdst, x, m, stab, interpret=False, tiles=None):
    """(out [n_dst, D], den [n_dst]), both f32. `stab` is the [n_dst]
    per-row score bound (segment.py _flash_stab)."""
    t = tiles or _tiles(*m.shape, x.shape[1])
    acc, den = _fwd_partials(ssrc, sdst, x, m, stab, t, interpret)
    den = jnp.sum(den, axis=0)
    return jnp.sum(acc, axis=0) / jnp.maximum(den, 1e-30)[:, None], den


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------


def _bwd_dst_kernel(stab_ref, sdst_ref, den_ref, srow_ref, ct_ref, ssrc_ref,
                    x_ref, m_ref, dsdst_ref, *, ts):
    td, chunk = m_ref.shape
    sdst = sdst_ref[...]
    stab = stab_ref[...]
    inv_den = 1.0 / jnp.maximum(den_ref[...], 1e-30)
    srow = srow_ref[...]
    ct = ct_ref[...]

    def body(j, acc):
        cols = pl.ds(j * ts, ts)
        z, pre = _tile_z(sdst, ssrc_ref[cols], m_ref[:, cols], stab)
        a = z * inv_den[:, None]
        da = _dot(ct, x_ref[cols, :], ((1,), (1,)), x_ref.dtype)
        w = a * jnp.where(pre > 0, 1.0, _SLOPE)
        return acc + jnp.sum(w * (da - srow[:, None]), axis=1)

    dsdst_ref[...] = jax.lax.fori_loop(
        0, chunk // ts, body, jnp.zeros((td,), jnp.float32)
    )


def _bwd_dst_partials(ssrc, sdst, x, m, stab, den, ct, srow, t, interpret):
    n_dst, n_src = m.shape
    d = x.shape[1]
    chunk = n_src // t.split
    row = pl.BlockSpec((t.td,), lambda i, k: (i,))
    return _call(
        functools.partial(_bwd_dst_kernel, ts=t.ts), "flash_gat_bwd_dst",
        (n_dst // t.td, t.split),
        [
            row, row, row, row,
            pl.BlockSpec((t.td, d), lambda i, k: (i, 0)),
            pl.BlockSpec((chunk,), lambda i, k: (k,)),
            pl.BlockSpec((chunk, d), lambda i, k: (k, 0)),
            pl.BlockSpec((t.td, chunk), lambda i, k: (i, k)),
        ],
        pl.BlockSpec((None, t.td), lambda i, k: (k, i)),
        jax.ShapeDtypeStruct((t.split, n_dst), jnp.float32),
        t.warps, interpret,
    )(stab, sdst, den, srow, ct, ssrc, x, m)


def _bwd_src_kernel(ssrc_ref, x_ref, stab_ref, sdst_ref, den_ref, srow_ref,
                    ct_ref, m_ref, dtab_ref, dssrc_ref, *, td):
    chunk, ts = m_ref.shape
    d = x_ref.shape[1]
    ssrc = ssrc_ref[...]
    x = x_ref[...]

    def body(i, carry):
        dtab, dssrc = carry
        rows = pl.ds(i * td, td)
        z, pre = _tile_z(sdst_ref[rows], ssrc, m_ref[rows, :], stab_ref[rows])
        a = z * (1.0 / jnp.maximum(den_ref[rows], 1e-30))[:, None]
        ct = ct_ref[rows, :]
        da = _dot(ct, x, ((1,), (1,)), x_ref.dtype)
        w = a * jnp.where(pre > 0, 1.0, _SLOPE)
        dp = w * (da - srow_ref[rows][:, None])
        dtab = dtab + _dot(a.astype(ct.dtype), ct, ((0,), (0,)), x_ref.dtype)
        return dtab, dssrc + jnp.sum(dp, axis=0)

    dtab, dssrc = jax.lax.fori_loop(
        0, chunk // td, body,
        (jnp.zeros((ts, d), jnp.float32), jnp.zeros((ts,), jnp.float32)),
    )
    dtab_ref[...] = dtab
    dssrc_ref[...] = dssrc


def _bwd_src_partials(ssrc, sdst, x, m, stab, den, ct, srow, t, interpret):
    n_dst, n_src = m.shape
    d = x.shape[1]
    chunk = n_dst // t.src_split
    col = pl.BlockSpec((t.src_ts,), lambda j, k: (j,))
    part = pl.BlockSpec((chunk,), lambda j, k: (k,))
    return _call(
        functools.partial(_bwd_src_kernel, td=t.src_td), "flash_gat_bwd_src",
        (n_src // t.src_ts, t.src_split),
        [
            col,
            pl.BlockSpec((t.src_ts, d), lambda j, k: (j, 0)),
            part, part, part, part,
            pl.BlockSpec((chunk, d), lambda j, k: (k, 0)),
            pl.BlockSpec((chunk, t.src_ts), lambda j, k: (k, j)),
        ],
        [
            pl.BlockSpec((None, t.src_ts, d), lambda j, k: (k, j, 0)),
            pl.BlockSpec((None, t.src_ts), lambda j, k: (k, j)),
        ],
        [
            jax.ShapeDtypeStruct((t.src_split, n_src, d), jnp.float32),
            jax.ShapeDtypeStruct((t.src_split, n_src), jnp.float32),
        ],
        t.src_warps, interpret,
    )(ssrc, x, stab, sdst, den, srow, ct, m)


@functools.partial(jax.jit, static_argnames=("interpret", "tiles"))
def flash_gat_backward(ssrc, sdst, x, m, stab, den, ct, srow,
                       interpret=False, tiles=None):
    """(d_ssrc [n_src], d_sdst [n_dst], d_table [n_src, D]), all f32.
    `srow` is the [n_dst] row statistic ct[i].out[i]."""
    t = tiles or _tiles(*m.shape, x.shape[1])
    ct = ct.astype(x.dtype)
    args = (_f32(ssrc), _f32(sdst), x, m, _f32(stab), _f32(den), ct,
            _f32(srow), t, interpret)
    dsdst = jnp.sum(_bwd_dst_partials(*args), axis=0)
    dtab, dssrc = _bwd_src_partials(*args)
    return jnp.sum(dssrc, axis=0), dsdst, jnp.sum(dtab, axis=0)


def _tiles(n_dst, n_src, d) -> FlashTiles:
    t = pick_tiles(n_dst, n_src, d)
    if t is None:
        raise ValueError(
            f"flash-GAT kernels do not take an [{n_dst}, {n_src}] incidence "
            f"matrix with width-{d} tables (see pick_tiles)"
        )
    return t


def _f32(v):
    return v.reshape(-1).astype(jnp.float32)
