"""Compiler back-end: ModelIR -> pure, jittable init/apply functions.

The reference builds a `tf.keras.Model` whose `call` reflectively walks the
IR and a `setattr` registry of submodels (generate_model.py:219-694), python-
unrolling the MP iterations and the graph batch into one TF graph. Here the
IR is walked ONCE at trace time to emit:

  * `init(rng, extra_dims)` -> parameter pytree (plain nested dicts keyed by
    stable string paths, mirroring the reference's variable registry
    generate_model.py:676-694);
  * `apply(params, batch, meta)` -> outputs, a pure function of statically
    shaped arrays: hidden-state init, `lax.scan` over MP iterations
    (NOT unrolled — reference unrolls at generate_model.py:406), stages/MPs
    unrolled (static model structure), readout pipeline.

Aggregation lowering is shape-driven:
  * single-vector aggregations (sum / attention / convolution) never build the
    padded [num_dst, max_len, D] tensor the reference always materializes
    (generate_model.py:477-491) — they lower straight to masked segment ops;
  * sequence aggregations (ordered / concat / interleave) scatter into the
    padded sequence tensor and update via a masked `lax.scan` GRU/LSTM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp

from ..frontend import ir as IR
from ..nn import mlp as MLP
from ..nn import rnn as RNN
from ..nn.layers import activation
from ..ops import segment as seg
from ..data.graph import BatchMeta, infer_readout_domains
from ..data.graph import interleave_tag as IVT

_SEQUENCE_AGGS = ("ordered", "concat", "interleave")

# iteration-body rematerialization (IGNNITION_TPU_ITER_REMAT=always): OFF by
# default — measured a net LOSS at flagship shapes for direct (243->199
# Medges/s), AND for per-edge message models (22.3->26.0 ms): the backward's
# recomputed gathers cost more than the residual-stack traffic they avoid
# (PERF.md 'Failed experiments'). Kept as an opt-in for memory-constrained
# giant batches, where halving scan residual memory matters more than speed.
_ITER_REMAT = __import__("os").environ.get("IGNNITION_TPU_ITER_REMAT", "never")
# split-first-Dense message creation: a per-edge MLP whose inputs are drawn
# from {hs_source, hs_dest, edge_params} runs its FIRST Dense layer as
# per-part matmuls at NODE rate (concat([a,b]) @ K == a @ K[:da] + b @ K[da:]),
# so the [E, D_src+D_dst(+P)] concat never materializes and the first-layer
# matmul (fwd dx/dW in the backward too) leaves the edge rate. Exact; tests
# toggle this global for parity against the concat formulation.
_SPLIT_FIRST = __import__("os").environ.get(
    "IGNNITION_TPU_SPLIT_FIRST_DENSE", "1"
) != "0"
# v2 halo comm/compute overlap (SURVEY §2.4 item 2 "overlapped with local
# segment-sum aggregation"): the source-row gather splits into an INTERIOR
# pass reading the local pre-halo block — independent of the all_to_all, so
# XLA's latency-hiding scheduler can run it while the collective is in
# flight — and a BOUNDARY pass reading only the received halo rows (a small
# cache-resident table). Exact by masking; 0 falls back to the synchronous
# extend-then-gather.
_HALO_OVERLAP = __import__("os").environ.get(
    "IGNNITION_TPU_HALO_OVERLAP", "1"
) != "0"
# slice-rate per-edge MLP messages for ordered updates: a message MLP over
# {hs_source, hs_dest} feeding an ordered aggregation evaluates at SLICE
# rate — pre[t, n] = (src_tbl @ Ksrc)[slice_src[t, n]] + (dst @ Kdst)[n] —
# so the destination part needs NO gather at all (indexed by n directly),
# the source part rides the same host-precomputed slice map the direct
# path uses, and no [E, D] per-edge tensor is ever materialized. Exact
# (same math per real slot; masked slots are ignored by the scan's length
# mask); 0 disables for A/B (tests/test_slice_mlp.py).
_SLICE_MLP = __import__("os").environ.get(
    "IGNNITION_TPU_SLICE_MLP", "1"
) != "0"
# run the slot-MLP tail on the [L, n_dst, H] tensor directly instead of a
# [L*n_dst, H] flatten + reshape: the flattened dot's output layout
# ({0,1}, batch-in-lanes) forces XLA to COPY the full [L*N, D] tensor to
# the {1,0} layout the recurrent scan slices (r5 profile: 1.44 ms/step of
# rnn.py-tagged layout copies in the mlp_message family). Exact for every
# stock layer (all are last-axis or elementwise — BatchNormalization uses
# frozen moving stats); custom registry layers may assume 2D, so those
# chains keep the flatten. 0 disables for A/B.
_SLOT_3D = __import__("os").environ.get(
    "IGNNITION_TPU_SLOT_3D", "1"
) != "0"
# run the slot-MLP tail per time slice INSIDE the ordered update's scan
# body instead of on the whole [L, n_dst, H] tensor: the whole-tensor
# tail's batch-in-lanes dot layout forces XLA to copy the full tensor into
# the scan's slicing layout every iteration (r5 mlp_message profile:
# 1.4 ms/step); in-body tails fuse with the gate matmuls and their interior
# activations drop out of the AD residual stack via the body's remat.
# 0 disables for A/B (then _SLOT_3D applies).
_SCAN_TAIL = __import__("os").environ.get(
    "IGNNITION_TPU_SCAN_TAIL", "1"
) != "0"
# slot-rate per-edge MLP messages for SUM aggregations: the same slice map
# lays the edges out as [max_in_degree, n_dst] slots, pre[t, d] =
# (src_tbl @ Ksrc)[slice_src[t, d]] + (dst @ Kdst)[d], and a masked dense
# sum over t replaces BOTH per-edge gathers and the segment sum. Pays
# (L*n_dst)/E padding overhead — skipped when that exceeds IR.SLOT_PAD_CAP
# (shared with the data layer's params_slice emission).
_SLOT_SUM = __import__("os").environ.get(
    "IGNNITION_TPU_SLOT_SUM", "1"
) != "0"
# slot-rate per-destination GAT: softmax over the [max_in_degree, n_dst]
# slot layout — L*n_dst score entries instead of the dense path's
# n_dst*n_src matrix (90x fewer at flagship shapes) and no per-edge
# gathers; covers source-local AND per-edge-MLP messages. Measured 2.3x
# over the dense-incidence path at flagship shapes (PERF.md).
_SLOT_ATTN = __import__("os").environ.get(
    "IGNNITION_TPU_SLOT_ATTN", "1"
) != "0"
# python-unrolled MP iterations (no lax.scan): AD then references
# loop-invariant values directly instead of stacking a copy per iteration
# into the scan residuals — profile-found on the attention family, whose
# scan stacked the (invariant) dense incidence matrix per iteration.
# Not yet re-measured on the GPU. Cost: compile time scales with
# num_iterations, so
# "auto" (default) unrolls up to _ITER_UNROLL_MAX iterations and keeps the
# scan beyond; 1/0 force either way.
_ITER_UNROLL_MODE = __import__("os").environ.get(
    "IGNNITION_TPU_ITER_UNROLL", "auto"
)
_ITER_UNROLL_MAX = int(
    __import__("os").environ.get("IGNNITION_TPU_ITER_UNROLL_MAX", 16)
)


def _iter_unroll(num_iterations: int) -> bool:
    if _ITER_UNROLL_MODE == "auto":
        return num_iterations <= _ITER_UNROLL_MAX
    return _ITER_UNROLL_MODE != "0"
_VECTOR_AGGS = ("sum", "attention", "convolution")


def _split_first_kernels(op, k0, w_src: int, w_dst: int, w_ep: int):
    """Split a first-Dense kernel's rows by the op's named-input layout:
    concat([hs_source | hs_dest | edge_params]) @ k0 decomposes into
    per-part matmuls with (ksrc, kdst, kep) — repeated inputs accumulate.
    ONE copy of the row walk, shared by the split-first message path and
    the slot-rate paths; must stay in lockstep with MLP init's input-dim
    accumulation (hence the layout assert)."""
    ksrc = kdst = kep = None
    lo = 0
    for name in op.inputs:
        if name == "hs_source":
            w = w_src
            sl = k0[lo : lo + w]
            ksrc = sl if ksrc is None else ksrc + sl
        elif name == "hs_dest":
            w = w_dst
            sl = k0[lo : lo + w]
            kdst = sl if kdst is None else kdst + sl
        else:
            w = w_ep
            sl = k0[lo : lo + w]
            kep = sl if kep is None else kep + sl
        lo += w
    assert lo == k0.shape[0], (
        f"first-Dense kernel layout drift: sliced {lo} rows of {k0.shape[0]}"
    )
    return ksrc, kdst, kep
# factored-last-Dense for sum-aggregated per-edge MLP messages (see the
# message-creation loop): exact algebra, on by default; 0 disables for A/B
_FACTOR_LAST = __import__("os").environ.get(
    "IGNNITION_TPU_FACTOR_LAST", "1"
) != "0"


class BuildError(ValueError):
    pass


@dataclass(frozen=True)
class _MessageDims:
    """Static dimension bookkeeping resolved at build time (the reference
    resolves the same quantities while constructing submodels,
    generate_model.py:245-346)."""

    # (stage, mp, source) -> message width. Keyed per SOURCE, not per
    # adjacency: one adjacency may feed several message passings with
    # different message widths (review-found — adjacency-keyed storage
    # built the earlier MP's attention kernels at the later MP's width)
    final_message_dim: Mapping[Tuple[int, int, int], int]
    named_output_dims: Mapping[str, int]  # message-op output_name -> width
    aggregated_dim: Mapping[Tuple[int, int], int]  # (stage, mp) -> update input width


def _resolve_dims(model_ir: IR.ModelIR) -> _MessageDims:
    state_dims = model_ir.state_dims()
    final_message_dim: Dict[Tuple[int, int, int], int] = {}
    named: Dict[str, int] = {}
    aggregated: Dict[Tuple[int, int], int] = {}

    for si, stage in enumerate(model_ir.stages):
        for mi, mp in enumerate(stage.passes):
            dst_dim = state_dims[mp.destination]
            per_source_dims = []
            for ki, src in enumerate(mp.sources):
                out_dim = state_dims[src.entity]  # direct assignation default
                for op in src.ops:
                    if op.kind == "mlp":
                        in_dim = 0
                        for name in op.inputs:
                            if name == "hs_source":
                                in_dim += state_dims[src.entity]
                            elif name == "hs_dest":
                                in_dim += dst_dim
                            elif name == "edge_params":
                                in_dim += src.edge_param_dim
                            else:
                                if name not in named:
                                    raise BuildError(
                                        f"message op input '{name}' has unknown width"
                                    )
                                in_dim += named[name]
                        out_dim = MLP.output_dim(op.mlp, in_dim)
                        if op.output_name:
                            named[op.output_name] = out_dim
                final_message_dim[(si, mi, ki)] = out_dim
                per_source_dims.append(out_dim)

            agg = mp.aggregation
            if agg.kind == "convolution":
                if per_source_dims[0] != dst_dim:
                    raise BuildError(
                        f"convolution aggregation requires message dim "
                        f"({per_source_dims[0]}) == destination state dim ({dst_dim})"
                    )
                aggregated[(si, mi)] = dst_dim
            elif agg.kind == "concat" and agg.concat_axis == 2:
                aggregated[(si, mi)] = sum(per_source_dims)
            else:
                aggregated[(si, mi)] = per_source_dims[0]

            if mp.update.kind == "mlp" and agg.kind in _SEQUENCE_AGGS:
                raise BuildError(
                    f"a feed-forward update requires a single-vector aggregation "
                    f"(sum/attention/convolution), got '{agg.kind}' for "
                    f"destination '{mp.destination}'"
                )

    return _MessageDims(final_message_dim, named, aggregated)


# ==========================================================================
# The compiled model
# ==========================================================================


class GnnModel:
    """A model compiled from IR. Stateless; all state lives in the params
    pytree and the GraphBatch."""

    def __init__(self, model_ir: IR.ModelIR):
        self.ir = model_ir
        self.dims = _resolve_dims(model_ir)
        self.state_dims = model_ir.state_dims()
        self.domains = infer_readout_domains(model_ir)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(
        self,
        rng: jax.Array,
        extra_dims: Optional[Mapping[str, int]] = None,
    ) -> Dict[str, Any]:
        """Initialize all parameters.

        extra_dims: widths of additional readout inputs coming straight from
        the dataset (rarely needed; entities and produced outputs cover the
        usual cases).
        """
        model_ir = self.ir
        state_dims = self.state_dims
        extra_dims = dict(extra_dims or {})
        params: Dict[str, Any] = {"message": {}, "aggregation": {}, "update": {}, "readout": {}}
        upd_in_dims: Dict[str, int] = {}

        for si, stage in enumerate(model_ir.stages):
            for mi, mp in enumerate(stage.passes):
                dst_dim = state_dims[mp.destination]
                for ki, src in enumerate(mp.sources):
                    for oi, op in enumerate(src.ops):
                        if op.kind != "mlp":
                            continue
                        in_dim = 0
                        for name in op.inputs:
                            if name == "hs_source":
                                in_dim += state_dims[src.entity]
                            elif name == "hs_dest":
                                in_dim += dst_dim
                            elif name == "edge_params":
                                in_dim += src.edge_param_dim
                            else:
                                in_dim += self.dims.named_output_dims[name]
                        rng, key = jax.random.split(rng)
                        p, _ = MLP.init(key, op.mlp, in_dim)
                        params["message"][f"s{si}/m{mi}/src{ki}/op{oi}"] = p

                agg = mp.aggregation
                msg_dim = self.dims.final_message_dim[(si, mi, 0)]
                if agg.kind == "attention":
                    rng, k1, k2, k3 = jax.random.split(rng, 4)
                    from ..nn.layers import glorot_uniform

                    params["aggregation"][f"s{si}/m{mi}"] = {
                        "kernel1": glorot_uniform(k1, (msg_dim, msg_dim)),
                        "kernel2": glorot_uniform(k2, (dst_dim, msg_dim)),
                        "attn_kernel": glorot_uniform(k3, (2 * msg_dim, 1)),
                    }
                elif agg.kind == "convolution":
                    rng, k1 = jax.random.split(rng)
                    from ..nn.layers import glorot_uniform

                    params["aggregation"][f"s{si}/m{mi}"] = {
                        "kernel": glorot_uniform(k1, (dst_dim, dst_dim)),
                    }

                upd = mp.update
                agg_dim = self.dims.aggregated_dim[(si, mi)]
                if upd.kind == "recurrent":
                    key_name = f"{mp.destination}_update"
                    if key_name not in params["update"]:
                        rng, key = jax.random.split(rng)
                        params["update"][key_name] = RNN.init(
                            key, upd.rnn, in_dim=agg_dim, units=dst_dim
                        )
                        upd_in_dims[key_name] = agg_dim
                else:
                    key_name = f"{mp.destination}_ff_update"
                    if key_name not in params["update"]:
                        rng, key = jax.random.split(rng)
                        p, _ = MLP.init(
                            key, upd.mlp, in_dim=agg_dim + dst_dim, last_units=dst_dim
                        )
                        params["update"][key_name] = p
                        upd_in_dims[key_name] = agg_dim
                # the update model is shared per destination (reference
                # semantics, generate_model.py:313/326): every message
                # passing that feeds it must aggregate to the same width
                if upd_in_dims[key_name] != agg_dim:
                    raise BuildError(
                        f"the message passings updating '{mp.destination}' "
                        f"aggregate to different dimensionalities "
                        f"({upd_in_dims[key_name]} vs {agg_dim}); the "
                        f"destination's update model is shared, so every "
                        f"message passing feeding it must produce messages "
                        f"of the same width"
                    )

        # readout models (reference generate_model.py:350-382)
        ro_dims: Dict[str, int] = dict(state_dims)
        ro_dims.update(self.dims.named_output_dims)
        ro_dims.update(extra_dims)
        for i, op in enumerate(model_ir.readout):
            if op.kind in ("predict", "neural_network"):
                in_dim = sum(ro_dims[name] for name in op.inputs)
                rng, key = jax.random.split(rng)
                p, out_dim = MLP.init(key, op.mlp, in_dim)
                params["readout"][f"op{i}"] = p
                if op.kind == "neural_network":
                    ro_dims[op.output_name] = out_dim
            elif op.kind == "pooling":
                ro_dims[op.output_name] = ro_dims[op.inputs[0]]
            elif op.kind == "product":
                ro_dims[op.output_name] = (
                    1 if op.product == "dot_product" else ro_dims[op.inputs[0]]
                )
            elif op.kind == "extend_adjacencies":
                ro_dims[op.output_names[0]] = ro_dims[op.inputs[0]]
                ro_dims[op.output_names[1]] = ro_dims[op.inputs[1]]
        return params

    # ------------------------------------------------------------------
    # regularization
    # ------------------------------------------------------------------

    def regularization_loss(self, params) -> jnp.ndarray:
        """Sum of all layers' l2 kernel penalties (the reference's
        `sum(model.losses)`, generate_model.py:749)."""
        total = jnp.float32(0.0)
        counted_updates = set()  # ff updates are SHARED per destination —
        # count each parameter set's penalty once, like Keras model.losses
        # counts one loss per layer (review-found: per-MP counting doubled
        # the shared kernels' l2 when two passes update one destination)
        for si, stage in enumerate(self.ir.stages):
            for mi, mp in enumerate(stage.passes):
                for ki, src in enumerate(mp.sources):
                    for oi, op in enumerate(src.ops):
                        if op.kind == "mlp":
                            total += MLP.l2_loss(
                                op.mlp, params["message"][f"s{si}/m{mi}/src{ki}/op{oi}"]
                            )
                if mp.update.kind == "mlp":
                    key = f"{mp.destination}_ff_update"
                    if key not in counted_updates:
                        counted_updates.add(key)
                        total += MLP.l2_loss(mp.update.mlp, params["update"][key])
        for i, op in enumerate(self.ir.readout):
            if op.kind in ("predict", "neural_network"):
                total += MLP.l2_loss(op.mlp, params["readout"][f"op{i}"])
        return total

    # ------------------------------------------------------------------
    # apply
    # ------------------------------------------------------------------

    def apply(
        self,
        params,
        batch: Mapping[str, jnp.ndarray],
        meta: BatchMeta,
        *,
        training: bool = False,
        rng: Optional[jax.Array] = None,
        return_states: bool = False,
        return_iteration_states: bool = False,
        edge_axis: Optional[str] = None,
        node_axis: Optional[str] = None,
        compute_dtype=None,
    ):
        """Run the GNN forward. Returns predictions [rows] (last dim squeezed
        when 1), plus entity states if requested.

        compute_dtype: e.g. jnp.bfloat16 for mixed-precision — parameters and
        hidden states are cast for compute (halving the movement-bound edge
        traffic); the optimizer's master weights stay float32 and
        predictions are returned as float32.

        edge_axis: v1 edge sharding — edges split over the named mesh axis,
        node tables replicated, aggregations psum (parallel/steps.py).

        node_axis: v2 destination sharding — the batch holds this shard's
        node blocks and destination-owned edges (parallel/edgeshard.py);
        aggregations and updates are purely local, source tables extend with
        an all_to_all halo per adjacency (`halo_send_{adj}` in the batch),
        and only graph-level reductions (pooling, quirk-mode attention
        softmax) cross shards. Mutually exclusive with edge_axis.
        """
        if edge_axis is not None and node_axis is not None:
            raise BuildError("edge_axis and node_axis are mutually exclusive")
        model_ir = self.ir
        if compute_dtype is not None:
            params = jax.tree_util.tree_map(
                lambda x: x.astype(compute_dtype)
                if hasattr(x, "astype") and jnp.issubdtype(x.dtype, jnp.floating)
                else x,
                params,
            )

        # ---- hidden state initialization (reference a_c.py:128-160) ----
        states: Dict[str, jnp.ndarray] = {}
        for e in model_ir.entities:
            n = meta.nodes(e.name)
            mask = batch[f"node_mask_{e.name}"]
            parts = [batch[f.name].reshape(n, f.size) for f in e.features]
            total = sum(f.size for f in e.features)
            if total > e.state_dim:
                raise BuildError(
                    f"features of entity '{e.name}' ({total}) exceed its "
                    f"hidden_state_dimension ({e.state_dim})"
                )
            parts.append(jnp.zeros((n, e.state_dim - total), jnp.float32))
            state0 = jnp.concatenate(parts, axis=1) * mask[:, None]
            if compute_dtype is not None:
                state0 = state0.astype(compute_dtype)
            states[e.name] = state0

        entity_order = list(states.keys())

        def one_iteration(state_tuple, _):
            st = dict(zip(entity_order, state_tuple))
            st = self._message_passing_iteration(
                params, batch, meta, st, edge_axis=edge_axis, node_axis=node_axis
            )
            return tuple(st[k] for k in entity_order), (
                tuple(st[k] for k in entity_order) if return_iteration_states else None
            )

        body = one_iteration
        if _ITER_REMAT == "always":
            # memory-for-speed trade: halves scan residual memory, measured
            # slower at flagship shapes for every model family (PERF.md)
            body = jax.checkpoint(one_iteration)

        init_tuple = tuple(states[k] for k in entity_order)
        if _iter_unroll(model_ir.num_iterations):
            # python-unrolled iterations: no scan residual stacking — AD
            # references loop-invariant values (e.g. the dense incidence
            # matrix inside attention custom-VJP residuals) directly
            # instead of stacking a copy per iteration (see _ITER_UNROLL_MODE)
            st_tuple = init_tuple
            stacked = []
            for _ in range(model_ir.num_iterations):
                st_tuple, _ = body(st_tuple, None)
                if return_iteration_states:
                    stacked.append(st_tuple)
            final_tuple = st_tuple
            per_iter = (
                tuple(
                    jnp.stack([s[i] for s in stacked])
                    for i in range(len(entity_order))
                )
                if return_iteration_states
                else None
            )
        else:
            final_tuple, per_iter = jax.lax.scan(
                body, init_tuple, None, length=model_ir.num_iterations
            )
        states = dict(zip(entity_order, final_tuple))

        # ---- readout ----
        predictions = self._readout(
            params, batch, meta, states, training=training, rng=rng,
            node_axis=node_axis,
        )
        if compute_dtype is not None:
            predictions = predictions.astype(jnp.float32)

        if return_iteration_states:
            iters = {
                k: per_iter[i] for i, k in enumerate(entity_order)
            }  # each [num_iterations, N, D]
            return predictions, states, iters
        if return_states:
            return predictions, states
        return predictions

    # ------------------------------------------------------------------

    @staticmethod
    def _halo_src_table(batch, adj, table, node_axis):
        """v2 destination sharding: extend a local source-row table with the
        halo rows peers own (one all_to_all through the host-built
        `halo_send_{adj}` tables; parallel/edgeshard.py). Identity when not
        sharded or when the adjacency has no halo."""
        if node_axis is None:
            return table
        send = batch.get(f"halo_send_{adj}")
        if send is None:
            return table
        return seg.halo_extend(table, send, node_axis)

    @staticmethod
    def _halo_gather(batch, adj, table, src_idx, node_axis):
        """v2 source-row gather with comm/compute overlap (_HALO_OVERLAP).

        Interior edges (source row owned locally, remapped index < B) gather
        from the local PRE-halo block — that gather has no data dependency on
        the all_to_all, so the latency-hiding scheduler overlaps it with the
        collective. Boundary edges gather from the received halo rows alone
        (a small [n_shards*H, D] table). The two masked passes sum to exactly
        `halo_extend(table)[src_idx]` on real edges and a ZERO row on padding
        edges (downstream consumers mask padding regardless). AD: interior
        cotangents hit the local block directly; boundary cotangents route
        through the transposed all_to_all, as before."""
        send = batch.get(f"halo_send_{adj}")
        if node_axis is None or send is None:
            return table[src_idx]
        imask = batch.get(f"interior_emask_{adj}")
        if not _HALO_OVERLAP or imask is None:
            return seg.halo_extend(table, send, node_axis)[src_idx]
        bmask = batch[f"boundary_emask_{adj}"]
        b_src = table.shape[0]
        recv = seg.halo_recv(table, send, node_axis)
        idx_int = jnp.minimum(src_idx, b_src - 1)
        m_int = table[idx_int] * imask[:, None].astype(table.dtype)
        idx_bnd = jnp.clip(src_idx - b_src, 0, recv.shape[0] - 1)
        m_bnd = recv[idx_bnd] * bmask[:, None].astype(table.dtype)
        return m_int + m_bnd

    def _message_passing_iteration(
        self, params, batch, meta, states, edge_axis=None, node_axis=None
    ):
        model_ir = self.ir
        new_states = dict(states)
        edge_vars: Dict[str, jnp.ndarray] = {}

        for si, stage in enumerate(model_ir.stages):
            for mi, mp in enumerate(stage.passes):
                dst = mp.destination
                n_dst = meta.nodes(dst)
                dst_states = new_states[dst]
                agg = mp.aggregation

                # ---- per-source message creation ----
                per_source = []
                for ki, src in enumerate(mp.sources):
                    a = src.adj_name
                    src_idx = batch[f"src_{a}"]
                    dst_idx = batch[f"dst_{a}"]
                    seq_pos = batch[f"seq_{a}"]
                    emask = batch[f"edge_mask_{a}"]
                    node_table = None
                    post_linear = None  # factored last Dense (sum agg only)
                    if IR.is_source_local(src.ops):
                        # the whole chain is a function of the source node
                        # state: evaluate it once per NODE (the MLP runs on
                        # n_src rows instead of E edges) and let the fused/
                        # dense aggregation paths below consume the table
                        # directly — the per-edge gather here only feeds the
                        # fallback paths and is dead code (DCE'd) otherwise
                        node_table = new_states[src.entity]
                        for oi, op in enumerate(src.ops):
                            if op.kind == "direct":
                                node_table = new_states[src.entity]
                            else:
                                x = jnp.concatenate(
                                    [new_states[src.entity]] * len(op.inputs),
                                    axis=1,
                                )
                                node_table = MLP.apply(
                                    op.mlp,
                                    params["message"][
                                        f"s{si}/m{mi}/src{ki}/op{oi}"
                                    ],
                                    x,
                                )
                        if node_axis is not None:
                            messages = self._halo_gather(
                                batch, a, node_table, src_idx, node_axis
                            )
                        else:
                            messages = node_table[src_idx]
                    else:
                        # the DESTINATION side needs no permutation (edge
                        # lists are destination-sorted), so its transpose is a
                        # sorted segment sum for free; the source side's
                        # transpose sorts through the host permutation.
                        if node_axis is not None:
                            gathered_src = self._halo_gather(
                                batch, a, new_states[src.entity], src_idx,
                                node_axis,
                            )
                        elif edge_axis is None:
                            gathered_src = seg.gather_rows(
                                new_states[src.entity],
                                src_idx,
                                perm=batch.get(f"src_perm_{a}"),
                            )
                        else:
                            gathered_src = new_states[src.entity][src_idx]
                        rp = batch.get(f"row_ptr_{a}")
                        gathered_dst = (
                            seg.gather_by_dst(dst_states, dst_idx)
                            if rp is not None and edge_axis is None
                            else dst_states[dst_idx]
                        )

                        # factored-last-Dense: when a sum aggregation consumes
                        # an MLP message whose FINAL layer is linear Dense,
                        # sum_e(g(x_e) @ K + b) == (sum_e g(x_e)) @ K + deg*b
                        # — the last matmul, its [E, D_out] activations, and
                        # their backward all leave the edge rate. `post`
                        # carries (K, b) to the aggregation step.
                        last_oi = len(src.ops) - 1
                        factor_last = (
                            _FACTOR_LAST
                            and agg.kind == "sum"
                            and src.ops
                            and src.ops[last_oi].kind == "mlp"
                            and not src.ops[last_oi].output_name
                            and len(src.ops[last_oi].mlp.layers) >= 2
                            and MLP.can_factor_last(src.ops[last_oi].mlp)
                        )
                        messages = gathered_src
                        for oi, op in enumerate(src.ops):
                            if op.kind == "direct":
                                messages = gathered_src
                            elif (
                                _SPLIT_FIRST
                                and MLP.can_split_first(op.mlp)
                                and op.inputs
                                and all(
                                    n in ("hs_source", "hs_dest", "edge_params")
                                    for n in op.inputs
                                )
                            ):
                                # split-first-Dense: per-part matmuls at node
                                # rate, parts meet at edge rate pre-activation
                                pkey = params["message"][
                                    f"s{si}/m{mi}/src{ki}/op{oi}"
                                ]
                                k0 = pkey["layers"][0]["kernel"]
                                src_tbl = new_states[src.entity]
                                ksrc, kdst, kep = _split_first_kernels(
                                    op,
                                    k0,
                                    src_tbl.shape[1],
                                    dst_states.shape[1],
                                    batch[f"params_{a}"].shape[1]
                                    if f"params_{a}" in batch
                                    else 0,
                                )
                                pre = None
                                if ksrc is not None:
                                    # node-rate matmul on the LOCAL block;
                                    # the halo then moves `units`-wide rows
                                    t = src_tbl @ ksrc
                                    if node_axis is not None:
                                        part = self._halo_gather(
                                            batch, a, t, src_idx, node_axis
                                        )
                                    elif edge_axis is None:
                                        part = seg.gather_rows(
                                            t,
                                            src_idx,
                                            perm=batch.get(f"src_perm_{a}"),
                                        )
                                    else:
                                        part = t[src_idx]
                                    pre = part
                                if kdst is not None:
                                    t = dst_states @ kdst
                                    rp2 = batch.get(f"row_ptr_{a}")
                                    part = (
                                        seg.gather_by_dst(t, dst_idx)
                                        if rp2 is not None and edge_axis is None
                                        else t[dst_idx]
                                    )
                                    pre = part if pre is None else pre + part
                                if kep is not None:
                                    ep = batch[f"params_{a}"].astype(k0.dtype)
                                    part = ep @ kep
                                    pre = part if pre is None else pre + part
                                if factor_last and oi == last_oi:
                                    messages = MLP.prefix_from_first_preact(
                                        op.mlp, pkey, pre
                                    )
                                    post_linear = MLP.last_dense(op.mlp, pkey)
                                else:
                                    messages = MLP.apply_from_first_preact(
                                        op.mlp, pkey, pre
                                    )
                                if op.output_name:
                                    edge_vars[op.output_name] = messages
                            else:
                                inputs = []
                                for name in op.inputs:
                                    if name == "hs_source":
                                        inputs.append(gathered_src)
                                    elif name == "hs_dest":
                                        inputs.append(gathered_dst)
                                    elif name == "edge_params":
                                        # match the split path's cast target
                                        # (k0.dtype == compute dtype) so both
                                        # formulations compute the first
                                        # layer in the same precision
                                        inputs.append(
                                            batch[f"params_{a}"].astype(
                                                gathered_src.dtype
                                            )
                                        )
                                    else:
                                        inputs.append(edge_vars[name])
                                x = jnp.concatenate(inputs, axis=1)
                                pkey2 = params["message"][
                                    f"s{si}/m{mi}/src{ki}/op{oi}"
                                ]
                                if factor_last and oi == last_oi:
                                    messages = MLP.apply_prefix(op.mlp, pkey2, x)
                                    post_linear = MLP.last_dense(op.mlp, pkey2)
                                else:
                                    messages = MLP.apply(op.mlp, pkey2, x)
                                if op.output_name:
                                    edge_vars[op.output_name] = messages

                    messages = messages * emask[:, None].astype(messages.dtype)  # zero padding edges
                    per_source.append(
                        dict(
                            messages=messages,
                            src_idx=src_idx,
                            dst_idx=dst_idx,
                            seq=seq_pos,
                            mask=emask,
                            adj=a,
                            entity=src.entity,
                            table=node_table,
                            row_ptr=batch.get(f"row_ptr_{a}"),
                            post=post_linear,
                        )
                    )

                def compute_lens(_ps=per_source, _n=n_dst, _ax=edge_axis):
                    """Per-destination real-message counts (the reference's
                    unsorted_segment_sum of ones, generate_model.py:481-482).
                    Precomputed host-side by the data layer; the scatter-based
                    fallback covers hand-built batches. Precomputed counts are
                    global, which is exactly what the sharded path needs too
                    (they feed only post-all-reduce uses)."""
                    out = []
                    for s in _ps:
                        key = f"lens_{s['adj']}"
                        if key in batch:
                            out.append(batch[key])
                        else:
                            out.append(
                                seg.segment_count(
                                    s["dst_idx"], _n, s["mask"], axis_name=_ax
                                )
                            )
                    return out

                # ---- aggregation ----
                fast_ordered = (
                    agg.kind == "ordered"
                    and len(per_source) == 1
                    and mp.update.kind == "recurrent"
                    and edge_axis is None
                    and f"row_ptr_{per_source[0]['adj']}" in batch
                )
                slice_xs = None
                if (
                    fast_ordered
                    and node_axis is None
                    and per_source[0]["table"] is None
                ):
                    # slice-rate per-edge MLP into the ordered update
                    # (_SLICE_MLP / _slot_messages; the message-loop's
                    # per-edge formulation above is unused here and DCE'd by
                    # XLA). capped=False: the [L, n_dst] layout is inherent
                    # to the scan, so slot padding costs nothing extra.
                    # return_tail: the MLP tail runs per-slice INSIDE the
                    # scan body — the scan consumes the gather-produced
                    # pre-activations directly (see _slot_messages doc).
                    slice_xs = self._slot_messages(
                        mp.sources[0],
                        per_source[0],
                        params["message"].get(f"s{si}/m{mi}/src0/op0"),
                        dst_states,
                        new_states,
                        batch,
                        meta,
                        n_dst,
                        enabled=_SLICE_MLP,
                        capped=False,
                        return_tail=_SCAN_TAIL,
                    )
                if slice_xs is not None:
                    if isinstance(slice_xs, tuple):
                        slice_xs, tail_fn = slice_xs
                    else:
                        tail_fn = None
                    a0 = per_source[0]["adj"]
                    node_mask = batch[f"node_mask_{dst}"]
                    up = params["update"][f"{dst}_update"]
                    new_state = RNN.masked_update_stacked(
                        mp.update.rnn,
                        up,
                        slice_xs,
                        batch[f"lens_{a0}"].astype(jnp.int32),
                        dst_states,
                        step_fn=tail_fn,
                    )
                    new_states[dst] = new_state * node_mask[:, None].astype(
                        new_state.dtype
                    )
                    continue
                if (
                    fast_ordered
                    and per_source[0]["table"] is not None
                    and f"slice_src_{per_source[0]['adj']}" in batch
                ):
                    # source-local ordered update: no per-edge message
                    # materialization at all — the scan's time slices gather
                    # straight from the node-level message table through the
                    # host-precomputed slice_src map, and the transpose is a
                    # sorted segment sum (ops.segment.gather_state_slices)
                    s0 = per_source[0]
                    a0 = s0["adj"]
                    xs = seg.gather_state_slices(
                        s0["table"],
                        batch[f"slice_src_{a0}"],
                        batch[f"slice_sort_perm_{a0}"],
                        batch[f"slice_sort_ids_{a0}"],
                        batch[f"slice_sort_row_ptr_{a0}"],
                    )
                    node_mask = batch[f"node_mask_{dst}"]
                    up = params["update"][f"{dst}_update"]
                    new_state = RNN.masked_update_stacked(
                        mp.update.rnn,
                        up,
                        xs,
                        batch[f"lens_{a0}"].astype(jnp.int32),
                        dst_states,
                    )
                    new_states[dst] = new_state * node_mask[:, None].astype(new_state.dtype)
                    continue
                if fast_ordered:
                    # no padded-sequence materialization: the masked RNN
                    # gathers its time slices straight from the sorted edge
                    # messages (see nn/rnn.py masked_update_from_edges)
                    s0 = per_source[0]
                    row_ptr = batch[f"row_ptr_{s0['adj']}"][:-1]
                    lens0 = batch[f"lens_{s0['adj']}"].astype(jnp.int32)
                    node_mask = batch[f"node_mask_{dst}"]
                    up = params["update"][f"{dst}_update"]
                    new_state = RNN.masked_update_from_edges(
                        mp.update.rnn,
                        up,
                        s0["messages"],
                        row_ptr,
                        s0["seq"],
                        s0["dst_idx"],
                        lens0,
                        dst_states,
                        meta.maxlen(s0["adj"]),
                    )
                    new_states[dst] = new_state * node_mask[:, None].astype(new_state.dtype)
                    continue

                fast_ilv = (
                    agg.kind == "interleave"
                    and mp.update.kind == "recurrent"
                    and edge_axis is None
                    and f"ilv_slice_{IVT(dst, si, mi)}" in batch
                    and all(s["table"] is not None for s in per_source)
                    and len({int(s["table"].shape[1]) for s in per_source}) == 1
                )
                if fast_ilv:
                    # source-local interleave: the scan's time slices gather
                    # straight from the concatenated node-level message
                    # tables through the host-precomputed combined slice map
                    # — no per-edge scatter, no take_along_axis permutation.
                    # Padding rows are zeroed so empty interleave slots
                    # contribute exact zeros (matching the scatter path).
                    tables = [
                        s["table"]
                        * batch[f"node_mask_{s['entity']}"][:, None].astype(
                            s["table"].dtype
                        )
                        for s in per_source
                    ]
                    comb_tbl = jnp.concatenate(tables, 0)
                    xs = seg.gather_state_slices(
                        comb_tbl,
                        batch[f"ilv_slice_{IVT(dst, si, mi)}"],
                        batch[f"ilv_sort_perm_{IVT(dst, si, mi)}"],
                        batch[f"ilv_sort_ids_{IVT(dst, si, mi)}"],
                        batch[f"ilv_sort_row_ptr_{IVT(dst, si, mi)}"],
                    )
                    lens_total = sum(compute_lens()).astype(jnp.int32)
                    node_mask = batch[f"node_mask_{dst}"]
                    up = params["update"][f"{dst}_update"]
                    new_state = RNN.masked_update_stacked(
                        mp.update.rnn, up, xs, lens_total, dst_states
                    )
                    new_states[dst] = new_state * node_mask[:, None].astype(
                        new_state.dtype
                    )
                    continue

                concat_axis = agg.concat_axis if agg.kind == "concat" else 1
                fast_concat = (
                    agg.kind in ("concat", "ordered")
                    and mp.update.kind == "recurrent"
                    and edge_axis is None
                    and all(s["table"] is not None for s in per_source)
                    and all(f"slice_src_{s['adj']}" in batch for s in per_source)
                    and (
                        len({int(s["table"].shape[1]) for s in per_source}) == 1
                        if concat_axis != 2
                        else len({meta.maxlen(s["adj"]) for s in per_source}) == 1
                    )
                )
                if fast_concat:
                    # source-local concat (and multi-source ordered, which
                    # flat-concats blocks too): per-source slice gathers from
                    # the node-mask-zeroed message tables replace the
                    # per-edge scatters; axis 1 stacks blocks on the time
                    # axis, axis 2 on features.
                    xs_blocks = [
                        seg.gather_state_slices(
                            s["table"]
                            * batch[f"node_mask_{s['entity']}"][:, None].astype(
                                s["table"].dtype
                            ),
                            batch[f"slice_src_{s['adj']}"],
                            batch[f"slice_sort_perm_{s['adj']}"],
                            batch[f"slice_sort_ids_{s['adj']}"],
                            batch[f"slice_sort_row_ptr_{s['adj']}"],
                        )
                        for s in per_source
                    ]
                    lens = compute_lens()
                    if concat_axis == 2:
                        xs = jnp.concatenate(xs_blocks, axis=2)
                        lens_total = lens[0].astype(jnp.int32)
                    else:
                        xs = jnp.concatenate(xs_blocks, axis=0)
                        lens_total = sum(lens).astype(jnp.int32)
                    node_mask = batch[f"node_mask_{dst}"]
                    up = params["update"][f"{dst}_update"]
                    new_state = RNN.masked_update_stacked(
                        mp.update.rnn, up, xs, lens_total, dst_states
                    )
                    new_states[dst] = new_state * node_mask[:, None].astype(
                        new_state.dtype
                    )
                    continue

                if agg.kind in _VECTOR_AGGS:
                    if agg.kind != "sum":
                        # (sum decomposes per source and may carry factored
                        # last-Dense prefixes of differing widths)
                        comb_msg = jnp.concatenate(
                            [s["messages"] for s in per_source], 0
                        )
                        comb_dst = jnp.concatenate(
                            [s["dst_idx"] for s in per_source], 0
                        )
                        comb_mask = jnp.concatenate(
                            [s["mask"] for s in per_source], 0
                        )
                    # single-source edge lists are destination-sorted by
                    # construction (data layer)
                    sorted_coo = len(per_source) == 1
                    if agg.kind == "sum":
                        lens_for_post = (
                            compute_lens()
                            if any(s["post"] is not None for s in per_source)
                            else None
                        )

                        def _finish(part, s, idx):
                            # factored last Dense (see message creation):
                            # one NODE-rate matmul + degree-scaled bias
                            if s["post"] is None:
                                return part
                            k2, b2 = s["post"]
                            out = part.astype(k2.dtype) @ k2
                            if b2 is not None:
                                deg = lens_for_post[idx].astype(out.dtype)
                                out = out + deg[:, None] * b2
                            return out

                        if edge_axis is not None:
                            aggregated = sum(
                                _finish(
                                    seg.segment_sum(
                                        s["messages"],
                                        s["dst_idx"],
                                        n_dst,
                                        indices_are_sorted=True,
                                        axis_name=edge_axis,
                                    ),
                                    s,
                                    i,
                                )
                                for i, s in enumerate(per_source)
                            )
                        else:
                            # per-source decomposition: each source's edge
                            # list is destination-sorted by construction, so
                            # EVERY source rides its own best fused path
                            # (multi-source sums included); the results add.
                            parts = []
                            for i, s in enumerate(per_source):
                                slot = self._slot_rate_sum(
                                    mp.sources[i],
                                    s,
                                    params["message"].get(
                                        f"s{si}/m{mi}/src{i}/op0"
                                    ),
                                    dst_states,
                                    new_states,
                                    batch,
                                    meta,
                                    n_dst,
                                )
                                part = (
                                    slot
                                    if slot is not None
                                    else self._one_source_sum(
                                        s, batch, meta, n_dst
                                    )
                                )
                                parts.append(_finish(part, s, i))
                            aggregated = sum(parts)
                    elif agg.kind == "attention":
                        ap = params["aggregation"][f"s{si}/m{mi}"]
                        a0 = per_source[0]["adj"]
                        slot_attn = None
                        if (
                            agg.attention_softmax != "reference"
                            and sorted_coo
                            and edge_axis is None
                            and node_axis is None
                            and _SLOT_ATTN
                            # source-local messages ride the dense-incidence
                            # paths when available (measured faster: 17.5 vs
                            # 21.8 ms at flagship shapes); the slot layout
                            # serves what they cannot — per-edge MLP chains,
                            # and source-local models without a dense
                            # companion (over the dense-size cap)
                            and not (
                                per_source[0]["table"] is not None
                                and (
                                    f"inc_blocks_{a0}" in batch
                                    or f"dense_inc_{a0}" in batch
                                )
                            )
                        ):
                            slot_attn = self._slot_attention(
                                mp.sources[0],
                                per_source[0],
                                params["message"].get(f"s{si}/m{mi}/src0/op0"),
                                ap,
                                dst_states,
                                new_states,
                                batch,
                                meta,
                                n_dst,
                            )
                        if slot_attn is not None:
                            aggregated = slot_attn
                        elif (
                            agg.attention_softmax != "reference"
                            and sorted_coo
                            and edge_axis is None
                            and per_source[0]["table"] is not None
                            and f"inc_blocks_{a0}" in batch
                        ):
                            # block-diagonal dense GAT (uniform merged
                            # batches): within-block softmax == merged dense
                            # softmax, G x fewer HBM bytes
                            aggregated = seg.dense_attention_aggregate_blocks(
                                per_source[0]["table"],
                                dst_states,
                                batch[f"inc_blocks_{a0}"],
                                ap["kernel1"],
                                ap["kernel2"],
                                ap["attn_kernel"],
                                n_dst,
                            )
                        elif (
                            agg.attention_softmax != "reference"
                            and sorted_coo
                            and edge_axis is None
                            and per_source[0]["table"] is not None
                            and f"dense_inc_{a0}" in batch
                        ):
                            # dense GAT: per-node score scalars + one masked
                            # softmax-matmul over the incidence matrix — no
                            # per-edge gathers (seg.dense_attention_aggregate)
                            aggregated = seg.dense_attention_aggregate(
                                per_source[0]["table"],
                                dst_states,
                                batch[f"dense_inc_{a0}"],
                                ap["kernel1"],
                                ap["kernel2"],
                                ap["attn_kernel"],
                            )
                        else:
                            aggregated = self._attention(
                                ap,
                                agg,
                                comb_msg,
                                comb_dst,
                                comb_mask,
                                dst_states,
                                per_source,
                                compute_lens,
                                n_dst,
                                meta,
                                edge_axis,
                                graph_id=batch[f"graph_id_{dst}"],
                                node_mask=batch[f"node_mask_{dst}"],
                                node_axis=node_axis,
                            )
                    else:  # convolution
                        ap = params["aggregation"][f"s{si}/m{mi}"]
                        a0 = per_source[0]["adj"]
                        if (
                            sorted_coo
                            and edge_axis is None
                            and per_source[0]["table"] is not None
                            and f"inc_blocks_{a0}" in batch
                        ):
                            # block-diagonal dense GCN (uniform merged batches)
                            nsum = seg.direct_segment_sum_blocks(
                                per_source[0]["table"] @ ap["kernel"],
                                batch[f"inc_blocks_{a0}"],
                                n_dst,
                            )
                        elif (
                            sorted_coo
                            and edge_axis is None
                            and per_source[0]["table"] is not None
                            and f"dense_inc_{a0}" in batch
                        ):
                            # dense GCN: one matmul over the incidence
                            # matrix replaces the gather + segment sum
                            nsum = seg.direct_segment_sum_dense(
                                per_source[0]["table"] @ ap["kernel"],
                                batch[f"dense_inc_{a0}"],
                            )
                        else:
                            weighted = comb_msg @ ap["kernel"]
                            nsum = seg.segment_sum(
                                weighted,
                                comb_dst,
                                n_dst,
                                indices_are_sorted=sorted_coo,
                                axis_name=edge_axis,
                            )
                        total = nsum + dst_states
                        # host-precomputed in-degrees when available (the
                        # device-side count is a width-1 scatter)
                        deg = sum(compute_lens())
                        normalized = total / jnp.maximum(deg, 1.0)[:, None]
                        aggregated = activation(agg.activation)(normalized)
                    final_len = None
                else:
                    # sequence aggregations: padded per-source blocks
                    blocks = [
                        seg.scatter_to_sequences(
                            s["messages"],
                            s["dst_idx"],
                            s["seq"],
                            n_dst,
                            meta.maxlen(s["adj"]),
                            axis_name=edge_axis,
                        )
                        for s in per_source
                    ]
                    lens = compute_lens()
                    if agg.kind == "concat" and agg.concat_axis == 2:
                        aggregated = jnp.concatenate(blocks, axis=2)
                        final_len = lens[0]
                    else:
                        aggregated = jnp.concatenate(blocks, axis=1)
                        final_len = sum(lens)
                        if agg.kind == "interleave":
                            perm = batch[f"interleave_perm_{IVT(dst, si, mi)}"]
                            rows = perm[batch[f"graph_id_{dst}"]]  # [n_dst, T_out]
                            aggregated = jnp.take_along_axis(
                                aggregated, rows[:, :, None], axis=1
                            )

                # ---- update ----
                # segment/scatter primitives may up-cast (e.g. the Pallas
                # kernel accumulates in f32); keep the compute dtype stable
                aggregated = aggregated.astype(dst_states.dtype)
                node_mask = batch[f"node_mask_{dst}"]
                if mp.update.kind == "recurrent":
                    up = params["update"][f"{dst}_update"]
                    if agg.kind in _VECTOR_AGGS:
                        new_state = RNN.cell_step(
                            mp.update.rnn, up, aggregated, dst_states
                        )
                    else:
                        new_state = RNN.masked_update(
                            mp.update.rnn,
                            up,
                            aggregated,
                            final_len.astype(jnp.int32),
                            dst_states,
                        )
                else:
                    up = params["update"][f"{dst}_ff_update"]
                    x = jnp.concatenate([aggregated, dst_states], axis=1)
                    new_state = MLP.apply(mp.update.mlp, up, x)

                new_states[dst] = new_state * node_mask[:, None].astype(new_state.dtype)

        return new_states

    # ------------------------------------------------------------------

    def _slot_rate_sum(
        self, srcspec, s, pkey, dst_states, new_states, batch, meta, n_dst
    ):
        """Per-edge MLP over {hs_source, hs_dest} into a SUM aggregation at
        SLOT rate (_SLOT_SUM): the in-degree-sliced [L, n_dst] layout (the
        same host-precomputed slice_src map the ordered update uses) turns

            agg[d] = sum_e tail(relu((hs_src[s_e]|hs_dst[d]) @ K0 + b0))

        into one slice gather of (src_tbl @ Ksrc), a gather-free node-rate
        destination part, the MLP tail at slot rate, and a MASKED DENSE sum
        over t — no per-edge gathers and no segment op anywhere, forward or
        backward. Exact: valid slots compute the same math per edge; invalid
        slots are zeroed by the in-degree mask before the sum. When the
        message carries a factored last Dense (s['post']), the prefix sums
        here and _finish applies the final matmul at node rate. Returns the
        [n_dst, D] partial or None when ineligible (multi-op chains, inputs
        beyond hs_source/hs_dest, published output_name — per-edge layout
        required — or slot padding beyond _SLOT_SUM_CAP x edges)."""
        if s["table"] is not None:
            # source-local chains ride the dense-incidence/fused sum paths
            # (faster than the slot layout for plain sums; _one_source_sum)
            return None
        slots = self._slot_messages(
            srcspec, s, pkey, dst_states, new_states, batch, meta, n_dst,
            want_prefix=s["post"] is not None, enabled=_SLOT_SUM,
        )
        if slots is None:
            return None
        L_, N_ = slots.shape[:2]
        lens = batch[f"lens_{s['adj']}"].astype(jnp.int32)
        tmask = (
            jax.lax.broadcasted_iota(jnp.int32, (L_, N_), 0) < lens[None, :]
        )
        return jnp.sum(
            slots * tmask[:, :, None].astype(slots.dtype), axis=0
        )

    def _slot_messages(
        self, srcspec, s, pkey, dst_states, new_states, batch, meta, n_dst,
        want_prefix=False, enabled=True, capped=True, return_tail=False,
    ):
        """[L, n_dst, D] slot-rate message tensor over the in-degree-sliced
        layout, or None when ineligible. Two producers:

          * source-local chains (per-node message table): one slice gather;
          * per-edge MLPs over {hs_source, hs_dest, edge_params}: split-first
            per-part matmuls (node rate for states; the edge params come
            pre-relaid in the slot layout, data layer `params_slice_{adj}`),
            parts meet at slot rate, MLP tail (or the factored prefix,
            want_prefix) at slot rate.

        capped=False skips the slot-padding cap — for ordered updates the
        [L, n_dst] layout is inherent to the scan, so there is no padding
        penalty to avoid. Invalid slots carry garbage-but-finite rows —
        every consumer masks by the in-degree (t < lens) before reducing.

        return_tail=True returns (xs, tail_fn) instead of the finished slot
        tensor: xs is the gather-produced input ([L, n_dst, H] first-layer
        pre-activations for MLP chains; the message table slices for
        source-local chains) and tail_fn the per-slice remainder of the MLP
        (None when xs is already the message). The ordered update runs the
        tail INSIDE the scan body (rnn.masked_update_stacked step_fn) so
        the scan consumes gathers directly — the whole-tensor tail's
        batch-in-lanes layout forced a measured 1.4 ms/step full-tensor
        copy into the scan (r5 mlp_message profile)."""
        a0 = s["adj"]
        if (
            not enabled
            or f"slice_src_{a0}" not in batch
            or f"lens_{a0}" not in batch  # consumers mask slots by in-degree
        ):
            return None
        L = meta.maxlen(a0)
        if capped and L * n_dst > IR.SLOT_PAD_CAP * meta.edges(a0):
            return None

        def slice_gather(t):
            return seg.gather_state_slices(
                t,
                batch[f"slice_src_{a0}"],
                batch[f"slice_sort_perm_{a0}"],
                batch[f"slice_sort_ids_{a0}"],
                batch[f"slice_sort_row_ptr_{a0}"],
            )

        if s["table"] is not None:
            out = slice_gather(s["table"])
            return (out, None) if return_tail else out
        if not _SPLIT_FIRST or pkey is None:
            return None
        ops = srcspec.ops
        if not IR.is_slot_eligible(ops) or (
            "edge_params" in ops[0].inputs
            and f"params_slice_{a0}" not in batch
        ):
            return None
        op = ops[0]
        k0 = pkey["layers"][0]["kernel"]
        src_tbl = new_states[srcspec.entity]
        ksrc, kdst, kep = _split_first_kernels(
            op,
            k0,
            src_tbl.shape[1],
            dst_states.shape[1],
            batch[f"params_slice_{a0}"].shape[-1]
            if f"params_slice_{a0}" in batch
            else 0,
        )
        pre = None
        if ksrc is not None:
            pre = slice_gather(src_tbl @ ksrc)
        if kep is not None:
            part = batch[f"params_slice_{a0}"].astype(k0.dtype) @ kep
            pre = part if pre is None else pre + part
        if kdst is not None:
            part = (dst_states @ kdst)[None, :, :]
            if pre is None:
                # hs_dest-only chain: each of a destination's deg(d) edges
                # contributes the same message — broadcast over slots so the
                # masked reduction weights it by the in-degree
                pre = jnp.broadcast_to(part, (L,) + part.shape[1:])
            else:
                pre = pre + part
        L_, N_, H1 = pre.shape
        from ..nn.layers import SUPPORTED_LAYERS

        if return_tail:
            if want_prefix:
                tail = lambda x: MLP.prefix_from_first_preact(op.mlp, pkey, x)
            else:
                tail = lambda x: MLP.apply_from_first_preact(op.mlp, pkey, x)
            return pre, tail
        if _SLOT_3D and all(
            l.kind in SUPPORTED_LAYERS for l in op.mlp.layers
        ):
            # last-axis/elementwise layers apply to [L, N, H] unchanged; the
            # 3D dot's output layout matches the scan's slicing, killing the
            # full-tensor layout copy the 2D flatten forced (see _SLOT_3D)
            if want_prefix:
                return MLP.prefix_from_first_preact(op.mlp, pkey, pre)
            return MLP.apply_from_first_preact(op.mlp, pkey, pre)
        flat = pre.reshape(L_ * N_, H1)
        if want_prefix:
            slots = MLP.prefix_from_first_preact(op.mlp, pkey, flat)
        else:
            slots = MLP.apply_from_first_preact(op.mlp, pkey, flat)
        return slots.reshape(L_, N_, -1)

    def _slot_attention(
        self, srcspec, s, msg_pkey, ap, dst_states, new_states, batch, meta,
        n_dst,
    ):
        """Per-destination GAT softmax at SLOT rate (_SLOT_ATTN).

        scores[t, d] = LeakyReLU(a1.(K1 m[t, d]) + a2.(K2 h_d)) over the
        in-degree-sliced slot layout; masked softmax over the slot axis;
        out[d] = sum_t w[t, d] * m[t, d]. One slice gather (or the slot-rate
        split-first MLP) produces m — no per-edge gathers, no segment ops,
        no [n_dst, n_src] incidence matrix anywhere, forward or backward
        (the softmax statistics are dense masked reductions over L).
        Invalid slots are finite garbage masked to weight zero; empty
        destinations get an all-zero row (den guarded). Returns None when
        the slot layout is unavailable (then the dense-incidence / fused
        per-edge paths apply)."""
        slots = self._slot_messages(
            srcspec, s, msg_pkey, dst_states, new_states, batch, meta, n_dst,
        )
        if slots is None:
            return None
        a0 = s["adj"]
        L_, N_, Dm = slots.shape
        d1 = ap["kernel1"].shape[1]
        m1 = slots.reshape(L_ * N_, Dm) @ ap["kernel1"]
        s_src = (m1 @ ap["attn_kernel"][:d1]).reshape(L_, N_)
        s_dst = ((dst_states @ ap["kernel2"]) @ ap["attn_kernel"][d1:])
        scores = jax.nn.leaky_relu(
            s_src + s_dst.reshape(1, N_), negative_slope=0.2
        )
        lens = batch[f"lens_{a0}"].astype(jnp.int32)
        tmask = (
            jax.lax.broadcasted_iota(jnp.int32, (L_, N_), 0) < lens[None, :]
        )
        # softmax statistics in f32 (bf16 exp/sum drifts at long in-degrees)
        sf = jnp.where(tmask, scores.astype(jnp.float32), -jnp.inf)
        mx = jnp.max(sf, axis=0)
        ex = jnp.where(
            tmask, jnp.exp(sf - jnp.where(jnp.isfinite(mx), mx, 0.0)[None]),
            0.0,
        )
        den = jnp.sum(ex, axis=0)
        w = (ex / jnp.where(den > 0, den, 1.0)[None]).astype(slots.dtype)
        return jnp.einsum("ln,lnd->nd", w, slots)

    def _one_source_sum(self, s, batch, meta, n_dst):
        """Best available sum lowering for ONE destination-sorted source
        (single-device path). Preference order: dense-incidence matmul >
        bounded out-degree sliced backward > fused host-indexed backward >
        sorted segment sum over the per-edge messages (see PERF.md)."""
        a0 = s["adj"]
        if s["table"] is not None and f"inc_blocks_{a0}" in batch:
            # block-diagonal batched matmul (uniform merged batches): reads
            # G x fewer HBM bytes than the dense merged matrix
            return seg.direct_segment_sum_blocks(
                s["table"], batch[f"inc_blocks_{a0}"], n_dst
            )
        if s["table"] is not None and f"dense_inc_{a0}" in batch:
            # dense-incidence matmul: out = M @ table; the dot's AD
            # transpose is the whole backward
            return seg.direct_segment_sum_dense(
                s["table"], batch[f"dense_inc_{a0}"]
            )
        if (
            s["table"] is not None
            and f"bwd_slice_dst_{a0}" in batch
            and f"row_ptr_{a0}" in batch
        ):
            # fused source-local sum with bounded out-degree backward: a few
            # small table gathers replace the edge-order cotangent gather
            # and its segment-sum kernel call
            return seg.direct_segment_sum_sliced(
                s["table"],
                batch[f"src_{a0}"],
                batch[f"dst_{a0}"],
                batch[f"edge_mask_{a0}"],
                batch[f"bwd_slice_dst_{a0}"],
                batch[f"out_lens_{a0}"],
                n_dst,
                meta.nodes(s["entity"]),
            )
        if (
            s["table"] is not None
            and f"dst_in_src_order_{a0}" in batch
            and f"row_ptr_{a0}" in batch
        ):
            # fused source-local sum: backward uses host-indexed gathers +
            # sorted segment sums instead of scatter transposes
            return seg.direct_segment_sum(
                s["table"],
                batch[f"src_{a0}"],
                batch[f"dst_{a0}"],
                batch[f"edge_mask_{a0}"],
                batch[f"dst_in_src_order_{a0}"],
                batch[f"emask_src_order_{a0}"],
                batch[f"src_sorted_{a0}"],
                n_dst,
                meta.nodes(s["entity"]),
            )
        return seg.segment_sum(
            s["messages"],
            s["dst_idx"],
            n_dst,
            indices_are_sorted=True,
        )

    # ------------------------------------------------------------------

    def _attention(
        self,
        ap,
        agg,
        comb_msg,
        comb_dst,
        comb_mask,
        dst_states,
        per_source,
        compute_lens,
        n_dst,
        meta,
        edge_axis=None,
        graph_id=None,
        node_mask=None,
        node_axis=None,
    ):
        """GAT-style attention (reference Attention_aggr.calculate_input,
        auxilary_classes.py:278-344).

        Default mode 'per_destination' computes a numerically-stable softmax
        over each destination's incoming edges (the standard GAT semantics).
        Mode 'reference' reproduces the reference's softmax over axis 0 of the
        scattered [num_dst, max_len, 1] tensor (a_c.py:336), including the
        exp(0) contributions of empty slots. The reference evaluates one
        graph at a time, so its axis-0 softmax couples the destinations of
        THAT graph only — in a merged batch the softmax is therefore
        segmented per graph (and padded destination rows excluded), which
        keeps merged-batch == per-graph exact (ground-truthed against the
        reference in tests/test_reference_tf_parity.py).
        """
        sorted_single = len(per_source) == 1 and per_source[0]["row_ptr"] is not None
        t_src = comb_msg @ ap["kernel1"]
        # decomposed scores (attn_kernel . concat = a1 . t_src + a2 . t_dst):
        # the destination side collapses to a per-NODE scalar gathered per
        # edge — [n_dst] instead of a [E, D] gather, and gather_by_dst's
        # transpose is a sorted segment sum instead of a scatter-add
        d1 = ap["kernel1"].shape[1]
        s_src = (t_src @ ap["attn_kernel"][:d1]).reshape(-1)
        s_dst_node = (dst_states @ ap["kernel2"]) @ ap["attn_kernel"][d1:]
        if sorted_single and edge_axis is None:
            s_dst = seg.gather_by_dst(s_dst_node, comb_dst)[:, 0]
        else:
            s_dst = s_dst_node[comb_dst, 0]
        scores = jax.nn.leaky_relu(s_src + s_dst, negative_slope=0.2)

        if agg.attention_softmax == "reference":
            # per-source seq offsets (reference generate_model.py:538-541)
            seqs = []
            lens = compute_lens()
            offset = jnp.zeros((n_dst,), jnp.float32)
            for s, l in zip(per_source, lens):
                seqs.append(s["seq"] + offset[s["dst_idx"]].astype(s["seq"].dtype))
                offset = offset + l
            comb_seq = jnp.concatenate(seqs, 0)
            max_len = sum(meta.maxlen(s["adj"]) for s in per_source)
            scattered = seg.scatter_to_sequences(
                (scores * comb_mask)[:, None],
                comb_dst,
                comb_seq,
                n_dst,
                max_len,
                axis_name=edge_axis,
            )[:, :, 0]  # [n_dst, max_len]
            # per-graph softmax over the destination axis: real rows
            # (including empty exp(0) slots, the reference quirk) count,
            # padded rows are excluded so the result is padding-invariant
            mask2 = (node_mask > 0)[:, None]
            ng = meta.num_graphs
            neg = jnp.float32(-1e30)
            gmax = jax.ops.segment_max(
                jnp.where(mask2, scattered, neg), graph_id, ng
            )
            if node_axis is not None:
                # destination-sharded rows: a graph's destinations may span
                # shards, so the per-graph statistics combine across them.
                # pmax has no differentiation rule; the softmax is shift-
                # invariant in its max, so a constant max is exact
                gmax = jax.lax.pmax(jax.lax.stop_gradient(gmax), node_axis)
            ex = jnp.exp(scattered - gmax[graph_id]) * mask2
            den = jax.ops.segment_sum(ex, graph_id, ng)
            if node_axis is not None:
                den = jax.lax.psum(den, node_axis)
            coeff = ex / jnp.where(den > 0, den, 1.0)[graph_id]
            flat = coeff.reshape(n_dst * max_len)
            picked = flat[comb_dst * max_len + comb_seq]
            weights = picked * comb_mask
        elif (
            len(per_source) == 1
            and edge_axis is None
            and per_source[0]["row_ptr"] is not None
        ):
            # fused: normalize AFTER aggregation — no per-edge weights or
            # width-1 gathers anywhere (seg.sorted_softmax_aggregate)
            return seg.sorted_softmax_aggregate(
                comb_msg,
                scores,
                comb_dst,
                n_dst,
                comb_mask,
            )
        else:
            weights = seg.segment_softmax(
                scores, comb_dst, n_dst, comb_mask, axis_name=edge_axis
            )

        weighted = comb_msg * weights[:, None]
        return seg.segment_sum(
            weighted,
            comb_dst,
            n_dst,
            indices_are_sorted=sorted_single,
            axis_name=edge_axis,
        )

    # ------------------------------------------------------------------

    def _readout(self, params, batch, meta, states, *, training, rng,
                 node_axis=None):
        """Execute the readout pipeline (reference generate_model.py:607-658).

        Intermediates live in `ro`; tensors are domain-tagged so graph-level
        results broadcast back over nodes when combined with node-level ones.
        """
        model_ir = self.ir
        ro: Dict[str, jnp.ndarray] = {}
        domains = self.domains

        def domain_of(name):
            return domains.get(name, ("entity", name))

        def fetch(name):
            if name in ro:
                return ro[name]
            if name in states:
                return states[name]
            if name in batch:
                v = batch[name]
                return v.astype(jnp.float32) if v.ndim > 1 else v.astype(jnp.float32)[:, None]
            raise BuildError(f"readout input '{name}' is not available")

        def broadcast_to(x, from_dom, to_dom):
            if from_dom == to_dom or from_dom[0] != "graph" or to_dom[0] != "entity":
                return x
            gid = batch[f"graph_id_{to_dom[1]}"]
            return x[gid]

        result = None
        for i, op in enumerate(model_ir.readout):
            if op.kind in ("predict", "neural_network"):
                doms = [domain_of(n) for n in op.inputs]
                target = next((d for d in doms if d[0] != "graph"), doms[0])
                xs = [
                    broadcast_to(fetch(n), d, target) for n, d in zip(op.inputs, doms)
                ]
                x = jnp.concatenate(xs, axis=1) if len(xs) > 1 else xs[0]
                out = MLP.apply(
                    op.mlp,
                    params["readout"][f"op{i}"],
                    x,
                    deterministic=not training,
                    rng=rng,
                )
                if op.kind == "predict":
                    result = out[:, 0] if out.shape[-1] == 1 else out
                else:
                    ro[op.output_name] = out
            elif op.kind == "pooling":
                name = op.inputs[0]
                dom = domain_of(name)
                x = fetch(name)
                if dom[0] == "entity":
                    ro[op.output_name] = seg.graph_pool(
                        x,
                        batch[f"graph_id_{dom[1]}"],
                        meta.num_graphs,
                        batch[f"node_mask_{dom[1]}"],
                        op.pooling,
                        axis_name=node_axis,  # sharded rows -> combine partials
                    )
                else:
                    raise BuildError(
                        f"pooling over domain {dom} is not supported (input '{name}')"
                    )
            elif op.kind == "product":
                d1, d2 = domain_of(op.inputs[0]), domain_of(op.inputs[1])
                target = d1 if d1[0] != "graph" else d2
                x1 = broadcast_to(fetch(op.inputs[0]), d1, target)
                x2 = broadcast_to(fetch(op.inputs[1]), d2, target)
                if op.product == "dot_product":
                    # NOTE: the reference calls tf.tensordot(axes=0) — an OUTER
                    # product (a_c.py:1082-1083) — while its dimension
                    # bookkeeping records width 1 (generate_model.py:375-376).
                    # We implement the recorded intent: a row-wise dot product.
                    ro[op.output_name] = jnp.sum(x1 * x2, axis=-1, keepdims=True)
                else:
                    ro[op.output_name] = x1 * x2
            elif op.kind == "extend_adjacencies":
                adj = op.adj_name
                src_states = fetch(op.inputs[0])
                dst_states_ = fetch(op.inputs[1])
                # v2 destination sharding: the shard's src_{adj} indices
                # point into the halo-extended source layout — exchange the
                # final states' boundary rows once more (the destination
                # side is local by edge ownership)
                src_states = self._halo_src_table(batch, adj, src_states, node_axis)
                ro[op.output_names[0]] = src_states[batch[f"src_{adj}"]]
                ro[op.output_names[1]] = dst_states_[batch[f"dst_{adj}"]]
        return result


def build(model_ir: IR.ModelIR) -> GnnModel:
    return GnnModel(model_ir)
