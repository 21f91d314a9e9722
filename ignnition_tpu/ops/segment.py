"""Segment/scatter primitives — the SpMM-shaped hot path of message passing.

The reference's aggregation hot loop is `tf.gather` + `tf.scatter_nd` +
`tf.math.unsorted_segment_sum` (generate_model.py:432-491,
auxilary_classes.py:241-401). Here the same primitives are expressed for XLA,
with a Pallas (Triton) kernel behind the dense GAT attention aggregation
(ops/pallas/attention_kernels.py). All shapes are static; padding edges are
neutralized by masking messages to zero before aggregation.

Every primitive takes an optional `axis_name`: inside a shard_map whose named
axis partitions the EDGE dimension, the local partial result is combined with
an XLA collective (psum / pmax) over that axis — this is the edge-partitioned
model-parallel boundary exchange (destination nodes are replicated, edge
shards all-reduce their partial aggregates over the interconnect).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp

from .platform import kernels_enabled


def _maybe_psum(x: jnp.ndarray, axis_name: Optional[str]) -> jnp.ndarray:
    return jax.lax.psum(x, axis_name) if axis_name else x


def segment_sum(
    data: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    indices_are_sorted: bool = False,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Sum rows of `data` into `num_segments` buckets (XLA's scatter-add;
    `indices_are_sorted=True` for destination-ordered COO, which the
    dataset layer guarantees)."""
    out = jax.ops.segment_sum(
        data, segment_ids, num_segments, indices_are_sorted=indices_are_sorted
    )
    return _maybe_psum(out, axis_name)


def segment_softmax(
    scores: jnp.ndarray,  # [E] or [E, 1]
    segment_ids: jnp.ndarray,  # [E]
    num_segments: int,
    mask: jnp.ndarray,  # [E] 1.0 for real edges
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Per-segment softmax over edge scores, ignoring masked edges.

    Numerically stable (per-segment max subtraction). Masked edges get
    weight 0; empty segments produce all-zero weights. With `axis_name`, the
    per-segment max and normalizer are combined across edge shards, while the
    returned weights stay local to this shard's edges.
    """
    scores = scores.reshape(-1)
    neg_inf = jnp.finfo(scores.dtype).min
    masked_scores = jnp.where(mask > 0, scores, neg_inf)
    # the max subtraction is a per-segment constant shift — softmax is
    # invariant to it, so its gradient contribution is exactly zero;
    # stop_gradient (BEFORE the collective, so pmax sees a zero tangent)
    # both encodes that and sidesteps pmax's missing differentiation rule
    # (edge-partitioned attention TRAINING crashed on it — found by the
    # parallel DSL fuzz)
    seg_max = jax.lax.stop_gradient(
        jax.ops.segment_max(masked_scores, segment_ids, num_segments)
    )
    if axis_name:
        seg_max = jax.lax.pmax(seg_max, axis_name)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    exp = jnp.where(mask > 0, jnp.exp(masked_scores - seg_max[segment_ids]), 0.0)
    denom = jax.ops.segment_sum(exp, segment_ids, num_segments)
    denom = _maybe_psum(denom, axis_name)
    denom = jnp.where(denom > 0, denom, 1.0)
    return exp / denom[segment_ids]


def segment_count(
    segment_ids: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Number of (real) edges per segment — the reference's `lens`
    (generate_model.py:481-482)."""
    return _maybe_psum(
        jax.ops.segment_sum(mask, segment_ids, num_segments), axis_name
    )


def scatter_to_sequences(
    messages: jnp.ndarray,  # [E, D], already masked to zero on padding edges
    dst_idx: jnp.ndarray,  # [E]
    seq: jnp.ndarray,  # [E] position within destination
    num_dst: int,
    max_len: int,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Scatter per-edge messages into the padded per-destination sequence
    tensor [num_dst, max_len, D] (reference generate_model.py:477-491).

    Uses an additive scatter over a flattened index: real (dst, seq) slots are
    unique, and padding edges carry zero messages, so add == set. With
    `axis_name`, each edge shard scatters its slots and the padded blocks
    all-reduce (disjoint slots -> sum == union).
    """
    d = messages.shape[-1]
    flat_idx = dst_idx * max_len + seq
    out = jnp.zeros((num_dst * max_len, d), messages.dtype)
    out = out.at[flat_idx].add(messages)
    return _maybe_psum(out, axis_name).reshape(num_dst, max_len, d)


def graph_pool(
    x: jnp.ndarray,  # [N, D]
    graph_ids: jnp.ndarray,  # [N]
    num_graphs: int,
    node_mask: jnp.ndarray,  # [N]
    kind: str,
    axis_name: Optional[str] = None,
) -> jnp.ndarray:
    """Per-graph pooling (sum | mean | max) over node rows.

    Replaces the reference's whole-tensor `tf.reduce_*` pooling
    (auxilary_classes.py:1165-1185), which only works because it sees one
    graph at a time; with merged batches pooling is a segment reduction.

    With `axis_name` (destination-sharded node rows, parallel/edgeshard.py)
    each shard contributes its local rows and the per-graph partials combine
    with the matching collective (psum / pmax; means combine sum and count
    separately, so they stay exact).
    """
    xm = x * node_mask[:, None]
    if kind == "sum":
        return _maybe_psum(
            jax.ops.segment_sum(xm, graph_ids, num_graphs), axis_name
        )
    if kind == "mean":
        s = _maybe_psum(jax.ops.segment_sum(xm, graph_ids, num_graphs), axis_name)
        n = _maybe_psum(
            jax.ops.segment_sum(node_mask, graph_ids, num_graphs), axis_name
        )
        return s / jnp.maximum(n, 1.0)[:, None]
    if kind == "max":
        neg = jnp.finfo(x.dtype).min
        xmasked = jnp.where(node_mask[:, None] > 0, x, neg)
        m = jax.ops.segment_max(xmasked, graph_ids, num_graphs)
        if axis_name:
            # pmax has no differentiation rule; reconstruct the global max
            # differentiably: shards holding the max contribute their LOCAL
            # (differentiable) value as a zero-valued residual, psum routes
            # the cotangent back to those shards' rows (and marks the
            # result replicated for shard_map's vma inference). Cross-shard
            # ties must SPLIT the cotangent like the serial segment_max
            # VJP does: weight each shard's residual by its share of the
            # global tie count (the local VJP already splits evenly among
            # local ties).
            g = jax.lax.pmax(jax.lax.stop_gradient(m), axis_name)
            t_loc = jax.ops.segment_sum(
                jnp.where(
                    (node_mask[:, None] > 0)
                    & (xmasked >= g[graph_ids]), 1.0, 0.0
                ),
                graph_ids,
                num_graphs,
            )
            t_glob = jax.lax.psum(t_loc, axis_name)
            w = t_loc / jnp.maximum(t_glob, 1.0)
            m = g + jax.lax.psum(
                jnp.where(m >= g, m - jax.lax.stop_gradient(m), 0.0) * w,
                axis_name,
            )
        # empty segments: truly row-less ones come back -inf (isfinite
        # guard), but a segment whose rows are ALL masked maxes the finite
        # finfo.min fill (review-found: -3.4e38 leaked into the readout) —
        # zero both via the (global) real-row count
        cnt = _maybe_psum(
            jax.ops.segment_sum(node_mask, graph_ids, num_graphs), axis_name
        )
        return jnp.where(jnp.isfinite(m) & (cnt[:, None] > 0), m, 0.0)
    raise ValueError(f"unknown pooling kind '{kind}'")


def halo_extend(
    table: jnp.ndarray,  # [B, D] this shard's node block (or message table)
    send_idx: jnp.ndarray,  # [n_shards, H] rows this shard sends to each peer
    axis_name: str,
) -> jnp.ndarray:
    """Destination-sharded boundary exchange (parallel/edgeshard.py).

    Gathers the rows each peer needs from the local block and trades them
    with ONE all_to_all; returns concat([table, halo]) of static shape
    [B + n_shards*H, D]. Remapped edge source indices address received rows
    at B + owner*H + slot. Plain gather -> collective -> concat, so AD routes
    remote-row cotangents back through the transposed all_to_all and
    scatter-adds them into the owning shard's block automatically."""
    send = table[send_idx]  # [n_shards, H, D]
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0, concat_axis=0, tiled=True)
    return jnp.concatenate([table, recv.reshape(-1, table.shape[1])], axis=0)


def halo_recv(
    table: jnp.ndarray,
    send_idx: jnp.ndarray,
    axis_name: str,
) -> jnp.ndarray:
    """The halo rows ALONE ([n_shards*H, D]), without concatenating the local
    block — the interior/boundary overlap split (model/builder.py
    _halo_gather) keeps the local-table gather independent of this
    collective so XLA's latency-hiding scheduler can run it while the
    all_to_all is in flight."""
    send = table[send_idx]
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0, concat_axis=0, tiled=True)
    return recv.reshape(-1, table.shape[1])


@jax.custom_vjp
def _gather_rows_perm(states, idx, perm):
    return states[idx]


def _gr_fwd(states, idx, perm):
    return states[idx], (states.shape[0], jnp.zeros((), states.dtype), idx, perm)


def _gr_bwd(res, ct):
    n, proto, idx, perm = res
    ct_states = segment_sum(ct[perm], idx[perm], n, indices_are_sorted=True)
    return ct_states.astype(proto.dtype), None, None


_gather_rows_perm.defvjp(_gr_fwd, _gr_bwd)


def gather_rows(states, idx, perm=None):
    """Row gather with a sorted segment-sum transpose.

    XLA differentiates a gather into an unsorted scatter-add; when the
    caller provides a host-precomputed sort permutation of `idx`, the
    backward becomes a sorted segment sum instead."""
    if perm is None:
        return states[idx]
    return _gather_rows_perm(states, idx, perm)


# --------------------------------------------------------------------------
# Fused direct-assignation primitives (host-precomputed index companions)
# --------------------------------------------------------------------------
#
# For message passings whose message is the raw source state
# (direct_assignation — both flagship RouteNet stages), every hot op can be
# a gather driven by HOST-precomputed index vectors plus a sorted segment
# sum, avoiding unsorted scatter transposes entirely.


@jax.custom_vjp
def gather_state_slices(states, slice_src, sort_perm, sort_ids, sort_row_ptr):
    """xs[t, d] = states[slice_src[t, d]] — the ordered update's per-time-
    slice inputs read straight from the source state table.

    Transpose: ct_states = sorted-segment-sum of the flattened cotangents in
    source order (all index arrays host-precomputed; invalid slots point at
    the last source row and carry zero cotangent from the masked scan).
    `sort_row_ptr` has one [n_src + 1] block per sort window; only its
    length (the window count) is read."""
    return states[slice_src]


def _gss_fwd(states, slice_src, sort_perm, sort_ids, sort_row_ptr):
    out = states[slice_src]
    n_chunks = (sort_row_ptr.shape[0] - 1) // states.shape[0]
    return out, (
        states.shape[0],
        n_chunks,
        jnp.zeros((), states.dtype),
        sort_perm,
        sort_ids,
    )


def _gss_bwd(res, ct):
    n_src, n_chunks, proto, sort_perm, sort_ids = res
    l, n, d = ct.shape
    n_slots = l * n
    flat_src = ct.reshape(n_slots, d)
    # the data layer sorts slots within ~equal windows with LOCAL indices
    # (row gathers slow down once the gathered source exceeds ~262k rows);
    # gather each window from its sliced source, then one sorted segment
    # sum per window into the n_src rows
    if n_chunks > 1:
        w = -(-n_slots // n_chunks)
        ct_states = None
        for c in range(n_chunks):
            lo, hi = c * w, min((c + 1) * w, n_slots)
            part = flat_src[lo:hi][sort_perm[lo:hi]]
            ids_c = sort_ids[lo:hi] - c * n_src
            s = segment_sum(part, ids_c, n_src, indices_are_sorted=True)
            ct_states = s if ct_states is None else ct_states + s
    else:
        ct_states = segment_sum(
            flat_src[sort_perm], sort_ids, n_src, indices_are_sorted=True
        )
    return ct_states.astype(proto.dtype), None, None, None, None


gather_state_slices.defvjp(_gss_fwd, _gss_bwd)


def _masked_sorted_sum(m, ids, num, emask):
    """Sorted segment sum of per-edge rows with padding edges masked out."""
    m = m * emask[:, None].astype(m.dtype)
    return segment_sum(m, ids, num, indices_are_sorted=True)


def _dss_impl(src_states, src_idx, dst_idx, emask, num_dst):
    return _masked_sorted_sum(src_states[src_idx], dst_idx, num_dst, emask)


@functools.partial(jax.custom_vjp, nondiff_argnums=(7, 8))
def direct_segment_sum(
    src_states,
    src_idx,
    dst_idx,
    emask,
    dst_in_src_order,
    emask_src_order,
    src_sorted,
    num_dst,
    num_src,
):
    """sum aggregation of direct-assignation messages:
    out[d] = sum over edges e with dst[e]==d of src_states[src[e]].

    Forward: gather + sorted segment sum.
    Backward: ct_src[s] = sum over e with src[e]==s of ct[dst[e]] — computed
    as a gather of ct through the host-precomputed `dst_in_src_order` index
    vector followed by a source-sorted segment sum; no unsorted scatter."""
    return _dss_impl(src_states, src_idx, dst_idx, emask, num_dst)


def _dss_fwd(
    src_states,
    src_idx,
    dst_idx,
    emask,
    dst_in_src_order,
    emask_src_order,
    src_sorted,
    num_dst,
    num_src,
):
    out = _dss_impl(src_states, src_idx, dst_idx, emask, num_dst)
    return out, (
        jnp.zeros((), src_states.dtype),
        dst_in_src_order,
        emask_src_order,
        src_sorted,
    )


def _dss_bwd(num_dst, num_src, res, ct):
    proto, dst_in_src_order, emask_src_order, src_sorted = res
    ct_src = _masked_sorted_sum(
        ct[dst_in_src_order], src_sorted, num_src, emask_src_order
    )
    return (ct_src.astype(proto.dtype),) + (None,) * 6


direct_segment_sum.defvjp(_dss_fwd, _dss_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7))
def direct_segment_sum_sliced(
    src_states,
    src_idx,
    dst_idx,
    emask,
    bwd_slice_dst,  # [L_out, num_src] dst of the t-th edge of each source
    out_lens,  # [num_src] real out-degree
    num_dst,
    num_src,
):
    """direct_segment_sum whose backward uses the bounded out-degree slice
    map: ct_src[s] = sum_t ct[bwd_slice_dst[t, s]] masked by t < out_lens[s].
    A handful of small table gathers + fused masked adds replace the
    edge-order cotangent gather and its segment sum."""
    return _dss_impl(src_states, src_idx, dst_idx, emask, num_dst)


def _dsss_fwd(
    src_states, src_idx, dst_idx, emask, bwd_slice_dst, out_lens,
    num_dst, num_src,
):
    out = _dss_impl(src_states, src_idx, dst_idx, emask, num_dst)
    return out, (jnp.zeros((), src_states.dtype), bwd_slice_dst, out_lens)


def _dsss_bwd(num_dst, num_src, res, ct):
    proto, bwd_slice_dst, out_lens = res
    l_out = bwd_slice_dst.shape[0]
    acc = None
    for t in range(l_out):
        valid = (out_lens > t).astype(ct.dtype)[:, None]
        part = ct[bwd_slice_dst[t]] * valid
        acc = part if acc is None else acc + part
    return (acc.astype(proto.dtype),) + (None,) * 5


direct_segment_sum_sliced.defvjp(_dsss_fwd, _dsss_bwd)


def direct_segment_sum_dense(src_states, dense_inc):
    """sum aggregation of direct-assignation messages via the dense
    incidence (multiplicity) matrix: out = M @ src_states.

    One matmul replaces the per-edge gather + sorted segment sum, and
    jax AD's dot transpose (d_states = M^T @ d_out) replaces the backward's
    cotangent gathers — no gather/scatter anywhere, pure sequential HBM
    traffic. Emitted by the data layer when n_dst*n_src is small enough
    (data/graph.py dense_sum_adjacencies / _DENSE_INC_MAX_ENTRIES).

    M is bf16 (exact for edge multiplicities up to 256); bf16 states run a
    single DEFAULT-precision pass with f32 accumulation, f32 states use
    HIGHEST (M's values convert exactly)."""
    prec = (
        jax.lax.Precision.HIGHEST
        if src_states.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    out = jax.lax.dot_general(
        dense_inc.astype(src_states.dtype),
        src_states,
        (((1,), (0,)), ((), ())),
        precision=prec,
        preferred_element_type=jnp.float32,
    )
    return out.astype(src_states.dtype)


def direct_segment_sum_blocks(src_states, blocks, n_dst_pad):
    """Block-diagonal batched form of `direct_segment_sum_dense` for merged
    batches of G equal-sized graphs.

    The merged batch's incidence matrix is block-diagonal by graph; for
    uniform graphs graph g's real rows occupy [g*bs, (g+1)*bs) of the merged
    node table, so the whole aggregation is reshapes around ONE batched
    matmul over [G, bd, bs] per-graph blocks — G x fewer HBM bytes than the
    [G*bd, G*bs] dense matrix (whose off-diagonal is structurally zero),
    restoring linear throughput scaling with batch size. AD's dot transpose
    (d_states = blocks^T @ d_out, batched) is the whole backward; padded
    tail rows fall out of the slice/pad and get exactly zero
    output/cotangent, matching the dense path.
    """
    g, bd, bs = blocks.shape
    d = src_states.shape[-1]
    prec = (
        jax.lax.Precision.HIGHEST
        if src_states.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    x = src_states[: g * bs].reshape(g, bs, d)
    out = jax.lax.dot_general(
        blocks.astype(src_states.dtype),
        x,
        (((2,), (1,)), ((0,), (0,))),
        precision=prec,
        preferred_element_type=jnp.float32,
    )
    out = out.reshape(g * bd, d).astype(src_states.dtype)
    if n_dst_pad > g * bd:
        out = jnp.concatenate(
            [out, jnp.zeros((n_dst_pad - g * bd, d), out.dtype)], axis=0
        )
    return out


def _dot(a, b, dims, dtype):
    prec = (
        jax.lax.Precision.HIGHEST
        if dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    return jax.lax.dot_general(
        a, b, (dims, ((), ())), precision=prec, preferred_element_type=jnp.float32
    )


@jax.custom_vjp
def _dense_masked_softmax_matmul(ssrc, sdst, msg_table, dense_inc):
    """out[d] = sum_s A[d, s] * msg_table[s] with
    A = row-softmax of LeakyReLU(sdst[d] + ssrc[s]) over the support of the
    dense incidence matrix (multiplicity-weighted, numerically stable).

    Custom VJP so the [n_dst, n_src] attention matrix is RECOMPUTED in the
    backward from the per-node score vectors instead of being stacked as a
    per-iteration residual of the outer MP scan (8 iterations x 64 MB
    would dominate device memory). The backward is MATMUL-FACTORED
    (flash-attention style): no [n_dst, n_src] f32 intermediate is ever
    materialized — the softmax-VJP row statistic is the row-dot of the
    cotangent with the recomputed output (sum_s dA[d,s]*A[d,s] =
    ct[d].out[d]), and the per-node score gradients collapse into matmuls
    against A and W = A*LeakyReLU', instead of materializing
    da=[n_dst, n_src] in f32 and reducing it.
    IGNNITION_TPU_DENSE_ATTN_BWD=legacy restores the materializing
    backward for A/B."""
    out, _ = _dmsm_compute(ssrc, sdst, msg_table, dense_inc)
    return out


def _dmsm_attn(ssrc, sdst, dense_inc, dtype):
    """The [n_dst, n_src] attention matrix in the compute dtype, without
    materializing the f32 score matrix: LeakyReLU is monotone, so the
    masked row max of e is lrelu(sdst + masked-rowmax(ssrc)) — a reduction
    over the (bf16) incidence support alone."""
    neg = jnp.float32(-1e30)
    m = dense_inc
    srcf = ssrc.astype(jnp.float32)
    sup = jnp.max(jnp.where(m > 0, srcf[None, :], neg), axis=1)
    row_max = jax.nn.leaky_relu(
        sdst.astype(jnp.float32) + sup, negative_slope=0.2
    )
    row_max = jnp.maximum(row_max, neg * 0.5)  # empty rows: finite shift
    e = jax.nn.leaky_relu(
        sdst[:, None].astype(jnp.float32) + srcf[None, :], negative_slope=0.2
    )
    # the where guards empty rows (their shifted e would overflow exp; the
    # m multiply would then produce inf * 0 = NaN)
    z = jnp.where(m > 0, jnp.exp(e - row_max[:, None]), 0.0) * m.astype(
        jnp.float32
    )
    denom = jnp.sum(z, axis=1)
    return (z / jnp.maximum(denom, 1e-30)[:, None]).astype(dtype)


def _dmsm_compute(ssrc, sdst, msg_table, dense_inc):
    dtype = msg_table.dtype
    a = _dmsm_attn(ssrc, sdst, dense_inc, dtype)
    out = _dot(a, msg_table, ((1,), (0,)), dtype)
    return out.astype(dtype), a


def _dmsm_fwd(ssrc, sdst, msg_table, dense_inc):
    out, _ = _dmsm_compute(ssrc, sdst, msg_table, dense_inc)
    return out, (ssrc, sdst, msg_table, dense_inc)


def _dmsm_bwd_legacy(res, ct):
    ssrc, sdst, msg_table, dense_inc = res
    dtype = msg_table.dtype
    a = _dmsm_attn(ssrc, sdst, dense_inc, dtype)
    ct = ct.astype(dtype)
    d_table = _dot(a, ct, ((0,), (0,)), dtype).astype(msg_table.dtype)
    da = _dot(ct, msg_table, ((1,), (1,)), dtype)  # [n_dst, n_src] f32
    af = a.astype(jnp.float32)
    s_row = jnp.sum(da * af, axis=1, keepdims=True)
    de = af * (da - s_row)
    # LeakyReLU'(pre): slope by the sign of pre = sdst + ssrc (leaky_relu
    # is sign-preserving)
    pre = sdst[:, None].astype(jnp.float32) + ssrc[None, :].astype(jnp.float32)
    d_pre = de * jnp.where(pre > 0, 1.0, 0.2)
    d_sdst = jnp.sum(d_pre, axis=1).astype(sdst.dtype)
    d_ssrc = jnp.sum(d_pre, axis=0).astype(ssrc.dtype)
    return d_ssrc, d_sdst, d_table, None


def _dmsm_bwd(res, ct):
    """Matmul-factored dense-attention backward.

    With W = A * LeakyReLU'(pre) and dA[d,s] = ct[d].x[s]:
      s_row[d]  = sum_s A[d,s] dA[d,s]            = ct[d] . (A @ x)[d]
      d_sdst[d] = sum_s W[d,s](dA[d,s] - s_row[d]) = ct[d].(W@x)[d]
                                                     - s_row[d]*rowsum(W)[d]
      d_ssrc[s] = sum_d W[d,s](dA[d,s] - s_row[d]) = x[s].(W^T@ct)[s]
                                                     - (W^T@s_row)[s]
    so the only [n_dst, n_src] tensors are A and W in the COMPUTE dtype,
    each consumed by matmuls — no f32 matrix round-trips. A ones column on
    x and an s_row column on ct fold the row sums into the same matmuls."""
    if os.environ.get("IGNNITION_TPU_DENSE_ATTN_BWD") == "legacy":
        return _dmsm_bwd_legacy(res, ct)
    ssrc, sdst, msg_table, dense_inc = res
    dtype = msg_table.dtype
    a = _dmsm_attn(ssrc, sdst, dense_inc, dtype)
    pre = sdst[:, None].astype(jnp.float32) + ssrc[None, :].astype(jnp.float32)
    w = (a.astype(jnp.float32) * jnp.where(pre > 0, 1.0, 0.2)).astype(dtype)
    ct = ct.astype(dtype)
    x = msg_table.astype(dtype)

    d_table = _dot(a, ct, ((0,), (0,)), dtype).astype(msg_table.dtype)
    out_rec = _dot(a, x, ((1,), (0,)), dtype)  # [n_dst, D] f32
    s_row = jnp.sum(ct.astype(jnp.float32) * out_rec, axis=1)  # [n_dst]

    ones = jnp.ones((x.shape[0], 1), dtype)
    xe = jnp.concatenate([x, ones], axis=1)  # [n_src, D+1]
    wx = _dot(w, xe, ((1,), (0,)), dtype)  # [n_dst, D+1] f32
    d_sdst = (
        jnp.sum(ct.astype(jnp.float32) * wx[:, :-1], axis=1)
        - s_row * wx[:, -1]
    ).astype(sdst.dtype)

    cts = jnp.concatenate(
        [ct, s_row[:, None].astype(dtype)], axis=1
    )  # [n_dst, D+1]
    wt = _dot(w, cts, ((0,), (0,)), dtype)  # [n_src, D+1] f32
    d_ssrc = (
        jnp.sum(x.astype(jnp.float32) * wt[:, :-1], axis=1) - wt[:, -1]
    ).astype(ssrc.dtype)
    return d_ssrc, d_sdst, d_table, None


_dense_masked_softmax_matmul.defvjp(_dmsm_fwd, _dmsm_bwd)


# -- flash-attention lowering of the dense path (ops/pallas/attention_kernels):
# reads the incidence matrix once per kernel with every [TD, TS] attention
# tile in registers — no [n_dst, n_src] materialization in device memory.


def _flash_stab(ssrc, sdst):
    """PER-ROW score bound lrelu(sdst[d] + max ssrc) >= every e[d, s]
    (LeakyReLU monotonicity; [n_dst] vector, no pass over the matrix).
    Exact in the sdst spread — a destination's own score magnitude can
    never underflow its row (an all-rows global bound could: a +60-nat
    sdst outlier on ANOTHER row would push exp(e - stab) below the f32
    budget and zero that row's output AND gradients) — leaving only the
    ssrc-spread exposure sorted_segment_softmax documents as exact for
    GAT score ranges."""
    sup = jnp.max(ssrc.astype(jnp.float32))
    sup = jnp.where(jnp.isfinite(sup), sup, 0.0)
    s = jax.nn.leaky_relu(
        sdst.astype(jnp.float32) + sup, negative_slope=0.2
    )
    return jnp.where(jnp.isfinite(s), s, 0.0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def _flash_masked_softmax_matmul(ssrc, sdst, msg_table, dense_inc,
                                 interpret=False):
    """Same contract as `_dense_masked_softmax_matmul`, lowered through the
    flash kernels. Residuals are vectors only (out/den/stab) — the backward
    recomputes every attention tile from one more read of the incidence
    matrix per kernel. `interpret` runs the kernels in Pallas's interpreter
    (tests only)."""
    out, _, _ = _flash_fwd_impl(ssrc, sdst, msg_table, dense_inc, interpret)
    return out.astype(msg_table.dtype)


def _flash_fwd_impl(ssrc, sdst, msg_table, dense_inc, interpret):
    from .pallas.attention_kernels import flash_gat_forward

    stab = _flash_stab(ssrc, sdst)
    out, den = flash_gat_forward(
        ssrc, sdst, msg_table, dense_inc, stab, interpret=interpret
    )
    return out, den, stab


def _flash_fwd(ssrc, sdst, msg_table, dense_inc, interpret):
    out, den, stab = _flash_fwd_impl(
        ssrc, sdst, msg_table, dense_inc, interpret
    )
    return out.astype(msg_table.dtype), (
        ssrc, sdst, msg_table, dense_inc, out, den, stab)


def _flash_bwd(interpret, res, ct):
    from .pallas.attention_kernels import flash_gat_backward

    ssrc, sdst, x, m, out, den, stab = res
    # sum_s dA[d,s] A[d,s] = ct[d].out[d] — the flash softmax-VJP statistic,
    # from the f32 output: the bf16 one would shift it by out's rounding,
    # which the score gradients (differences against it) cannot absorb
    srow = jnp.sum(ct.astype(jnp.float32) * out, axis=1)
    d_ssrc, d_sdst, d_table = flash_gat_backward(
        ssrc, sdst, x, m, stab, den, ct, srow, interpret=interpret
    )
    return (
        d_ssrc.astype(ssrc.dtype),
        d_sdst.astype(sdst.dtype),
        d_table.astype(x.dtype),
        None,
    )


_flash_masked_softmax_matmul.defvjp(_flash_fwd, _flash_bwd)


def use_flash_attn(dense_inc, msg_table) -> bool:
    """The flash kernels run wherever kernels run (ops/platform.py), for
    bf16 message tables, when the [n_dst, n_src] matrix fits their tiles.

    bf16 only: in the attention cell's training step on an H100 the kernels
    beat XLA's dense path in bf16 and lose to it in f32, whose IEEE f32
    dots run off the tensor cores (PERF.md)."""
    from .pallas.attention_kernels import pick_tiles

    return (
        kernels_enabled()
        and msg_table.dtype == jnp.bfloat16
        and pick_tiles(*dense_inc.shape, msg_table.shape[1]) is not None
    )


def _bdot(a, b, dims, dtype):
    """Batched (leading-axis) dot_general with the dense-path precision
    policy."""
    prec = (
        jax.lax.Precision.HIGHEST
        if dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    return jax.lax.dot_general(
        a,
        b,
        (dims, ((0,), (0,))),
        precision=prec,
        preferred_element_type=jnp.float32,
    )


@jax.custom_vjp
def _blocks_masked_softmax_matmul(ssrc, sdst, msg_table, blocks):
    """Block-diagonal form of `_dense_masked_softmax_matmul` for uniform
    merged batches: per-graph [bd, bs] attention softmax + matmul, batched
    over G graphs. ssrc is [G*bs], sdst [G*bd], msg_table [G*bs, D] (callers
    slice the real rows; cross-graph support is structurally absent, so
    within-block softmax equals the merged dense softmax). Same custom VJP
    rationale: the [G, bd, bs] attention tensor is recomputed in the
    backward instead of stacked per MP iteration."""
    out, _ = _bmsm_compute(ssrc, sdst, msg_table, blocks)
    return out


def _bmsm_attn(ssrc, sdst, blocks, dtype):
    """Per-graph [g, bd, bs] attention tensor (see _dmsm_attn: the masked
    row max rides LeakyReLU's monotonicity, no f32 score tensor is
    materialized)."""
    g, bd, bs = blocks.shape
    neg = jnp.float32(-1e30)
    m = blocks
    srcf = ssrc.reshape(g, 1, bs).astype(jnp.float32)
    dstf = sdst.reshape(g, bd, 1).astype(jnp.float32)
    sup = jnp.max(jnp.where(m > 0, srcf, neg), axis=2)
    row_max = jax.nn.leaky_relu(
        dstf[:, :, 0] + sup, negative_slope=0.2
    )
    row_max = jnp.maximum(row_max, neg * 0.5)  # empty rows: finite shift
    e = jax.nn.leaky_relu(dstf + srcf, negative_slope=0.2)
    z = jnp.where(m > 0, jnp.exp(e - row_max[:, :, None]), 0.0) * m.astype(
        jnp.float32
    )
    denom = jnp.sum(z, axis=2)
    return (z / jnp.maximum(denom, 1e-30)[:, :, None]).astype(dtype)


def _bmsm_compute(ssrc, sdst, msg_table, blocks):
    g, bd, bs = blocks.shape
    dtype = msg_table.dtype
    a = _bmsm_attn(ssrc, sdst, blocks, dtype)
    x = msg_table.reshape(g, bs, -1)
    out = _bdot(a, x, ((2,), (1,)), dtype)  # [g, bd, D]
    return out.reshape(g * bd, -1).astype(dtype), a


def _bmsm_fwd(ssrc, sdst, msg_table, blocks):
    out, _ = _bmsm_compute(ssrc, sdst, msg_table, blocks)
    return out, (ssrc, sdst, msg_table, blocks)


def _bmsm_bwd(res, ct):
    """Matmul-factored backward, batched per graph (see _dmsm_bwd)."""
    ssrc, sdst, msg_table, blocks = res
    g, bd, bs = blocks.shape
    dtype = msg_table.dtype
    a = _bmsm_attn(ssrc, sdst, blocks, dtype)
    pre = (
        sdst.reshape(g, bd, 1).astype(jnp.float32)
        + ssrc.reshape(g, 1, bs).astype(jnp.float32)
    )
    w = (a.astype(jnp.float32) * jnp.where(pre > 0, 1.0, 0.2)).astype(dtype)
    ct3 = ct.reshape(g, bd, -1).astype(dtype)
    x = msg_table.reshape(g, bs, -1).astype(dtype)

    d_table = _bdot(a, ct3, ((1,), (1,)), dtype)  # [g, bs, D]
    d_table = d_table.reshape(g * bs, -1).astype(msg_table.dtype)
    out_rec = _bdot(a, x, ((2,), (1,)), dtype)  # [g, bd, D] f32
    s_row = jnp.sum(ct3.astype(jnp.float32) * out_rec, axis=2)  # [g, bd]

    ones = jnp.ones((g, bs, 1), dtype)
    xe = jnp.concatenate([x, ones], axis=2)  # [g, bs, D+1]
    wx = _bdot(w, xe, ((2,), (1,)), dtype)  # [g, bd, D+1] f32
    d_sdst = (
        jnp.sum(ct3.astype(jnp.float32) * wx[:, :, :-1], axis=2)
        - s_row * wx[:, :, -1]
    ).reshape(g * bd).astype(sdst.dtype)

    cts = jnp.concatenate(
        [ct3, s_row[:, :, None].astype(dtype)], axis=2
    )  # [g, bd, D+1]
    wt = _bdot(w, cts, ((1,), (1,)), dtype)  # [g, bs, D+1] f32
    d_ssrc = (
        jnp.sum(x.astype(jnp.float32) * wt[:, :, :-1], axis=2)
        - wt[:, :, -1]
    ).reshape(g * bs).astype(ssrc.dtype)
    return d_ssrc, d_sdst, d_table, None


_blocks_masked_softmax_matmul.defvjp(_bmsm_fwd, _bmsm_bwd)


def dense_attention_aggregate_blocks(
    msg_table, dst_states, blocks, kernel1, kernel2, attn_kernel, n_dst_pad
):
    """Block-diagonal form of `dense_attention_aggregate` for uniform merged
    batches — G x fewer HBM bytes than the merged [G*bd, G*bs] matrix."""
    g, bd, bs = blocks.shape
    d1 = kernel1.shape[1]
    a1 = attn_kernel[:d1]
    a2 = attn_kernel[d1:]
    dtype = msg_table.dtype
    ssrc = _dot(msg_table @ kernel1, a1, ((1,), (0,)), dtype)[:, 0]
    sdst = _dot(dst_states @ kernel2, a2, ((1,), (0,)), dtype)[:, 0]
    # per-graph blocks stay on XLA's batched softmax + matmul: each block is
    # small, and the single-matrix memory blowup the flash kernels avoid
    # does not arise
    out = _blocks_masked_softmax_matmul(
        ssrc[: g * bs], sdst[: g * bd], msg_table[: g * bs], blocks
    )
    if n_dst_pad > g * bd:
        out = jnp.concatenate(
            [out, jnp.zeros((n_dst_pad - g * bd, out.shape[-1]), out.dtype)],
            axis=0,
        )
    return out


def dense_attention_aggregate(
    msg_table,  # [n_src, D] per-source messages (direct assignation)
    dst_states,  # [n_dst, Dd]
    dense_inc,  # [n_dst, n_src] bf16 multiplicity matrix
    kernel1,  # [D, D]
    kernel2,  # [Dd, D]
    attn_kernel,  # [2D, 1]
):
    """GAT attention aggregation computed DENSELY over the incidence matrix.

    GATv1 scores decompose into per-node scalars:
      e[d, s] = LeakyReLU(a1 . (K1 m_s) + a2 . (K2 h_d))
    so when messages are per-source (direct assignation), the whole
    aggregation is two tiny per-node matmuls + dense broadcast/softmax/
    matmul over [n_dst, n_src] — no per-edge gathers, no scatters, no
    segment ops anywhere (cf. the sorted_segment_softmax edge path).
    Multiplicity k edges contribute k identical softmax terms, matching the
    per-edge semantics exactly.
    """
    d1 = kernel1.shape[1]
    a1 = attn_kernel[:d1]
    a2 = attn_kernel[d1:]
    dtype = msg_table.dtype
    ssrc = _dot(msg_table @ kernel1, a1, ((1,), (0,)), dtype)[:, 0]
    sdst = _dot(dst_states @ kernel2, a2, ((1,), (0,)), dtype)[:, 0]
    if use_flash_attn(dense_inc, msg_table):
        return _flash_masked_softmax_matmul(ssrc, sdst, msg_table, dense_inc)
    return _dense_masked_softmax_matmul(ssrc, sdst, msg_table, dense_inc)


@jax.custom_vjp
def gather_by_dst(values, dst_idx):
    """values[dst_idx] for a destination-SORTED edge list, whose transpose is
    a sorted segment sum instead of the unsorted scatter-add XLA would emit."""
    return values[dst_idx]


def _gbd_fwd(values, dst_idx):
    return values[dst_idx], (values.shape[0], jnp.zeros((), values.dtype), dst_idx)


def _gbd_bwd(res, ct):
    n, proto, dst_idx = res
    out = segment_sum(ct, dst_idx, n, indices_are_sorted=True)
    return out.astype(proto.dtype), None


gather_by_dst.defvjp(_gbd_fwd, _gbd_bwd)


def sorted_segment_softmax(
    scores: jnp.ndarray,  # [E] destination-sorted edge scores
    dst_idx: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Scatter-free per-destination softmax for sorted edge lists.

    Stabilizes with the GLOBAL max (per-destination max would need a
    scatter-max); exact for the typical GAT score ranges — a destination
    whose best score sits ~88 nats below the global max would underflow,
    which the generic `segment_softmax` (used on unsorted/multi-source
    paths) does not. The denominator gather's transpose is a sorted segment
    sum (gather_by_dst).
    """
    scores = scores.reshape(-1)
    stab = jnp.max(jnp.where(mask > 0, scores, -jnp.inf))
    stab = jnp.where(jnp.isfinite(stab), stab, 0.0)
    # double-where: exp must never see masked scores — a padding score
    # ~88 nats above the real max overflows exp to inf and the where-VJP's
    # 0*inf poisons the whole score gradient with NaN (review-found, with
    # a reproducing case; segment_softmax already guards this way)
    safe = jnp.where(mask > 0, scores, stab)
    exp = jnp.where(mask > 0, jnp.exp(safe - stab), 0.0)
    denom = segment_sum(
        exp, dst_idx, num_segments, indices_are_sorted=True
    )
    denom = jnp.where(denom > 0, denom, 1.0)
    return exp / gather_by_dst(denom, dst_idx)


def sorted_softmax_aggregate(
    messages: jnp.ndarray,  # [E, D] destination-sorted per-edge messages
    scores: jnp.ndarray,  # [E] destination-sorted edge scores
    dst_idx: jnp.ndarray,
    num_segments: int,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Fused masked softmax-weighted aggregation for sorted edge lists:
    out[d] = sum_e exp(s_e) m_e / sum_e exp(s_e).

    Normalizing AFTER aggregation (two sorted segment sums + a per-NODE
    division) removes every per-edge division from both passes — the
    per-edge attention weights are never materialized. Same global-max
    stabilization as sorted_segment_softmax."""
    scores = scores.reshape(-1)
    stab = jnp.max(jnp.where(mask > 0, scores, -jnp.inf))
    stab = jnp.where(jnp.isfinite(stab), stab, 0.0)
    # double-where against masked-score exp overflow (see
    # sorted_segment_softmax)
    safe = jnp.where(mask > 0, scores, stab)
    exp = jnp.where(mask > 0, jnp.exp(safe - stab), 0.0)
    num = segment_sum(
        messages * exp[:, None].astype(messages.dtype),
        dst_idx,
        num_segments,
        indices_are_sorted=True,
    )
    den = segment_sum(exp, dst_idx, num_segments, indices_are_sorted=True)
    return num / jnp.where(den > 0, den, 1.0)[:, None].astype(num.dtype)
