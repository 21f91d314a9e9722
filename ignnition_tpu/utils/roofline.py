"""Speed-of-light accounting for a training step.

Computes, from the IR + a BatchMeta, an itemized lower bound on the
MANDATORY work of one full training step (forward + backward + optimizer):

  * device-memory bytes — every value stream an implementation must move
    at least once, under an OPTIMISTIC fusion convention (anything that
    fits on-chip is assumed resident; node-rate tables count once per
    iteration; edge-rate streams count once per direction of AD):
      - aggregation input: the per-edge message stream E*D when the message
        is genuinely per-edge, or for SEQUENCE (ordered/interleave/concat)
        aggregations whose RNN consumes per-slot inputs; node tables
        (n*D) when a source-local message feeds a commutative aggregation
        (sum/attention/convolution) that can stream from the table;
      - dense incidence matrices where that lowering applies (1 byte per
        entry, once per read: 2 for a sum, 3 for the flash attention
        kernels);
      - index companions: E * 4 bytes, read in forward and backward;
      - updated state tables: n_d*D written fwd, cotangent read bwd;
      - per-edge MLP activations: E*units per interior layer boundary
        (1x fwd + 2x bwd: residual read + cotangent);
      - readout activations at domain row rate;
      - optimizer: ~20 bytes/param (p/m/v read+write, grad read).
  * FLOPs — 2*rows*in*out per Dense matmul, 12*D^2 per GRU element
    (16*D^2 LSTM), x3 for training (backward of a matmul is ~2x forward);
    aggregation adds E*D.
  * gather rows (a count, not part of the bound) — rows moved through
    data-dependent indices per step.

The bound is deliberately UNACHIEVABLE-optimistic (perfect fusion, zero
re-materialization, no padding): achieved % of it is a conservative
statement of headroom. Padded sizes from BatchMeta stand in for real sizes.
The device's peaks come from one table keyed by `device_kind`; a device
that is not in the table is an error, not a default.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class Peaks:
    """Published peak rates of one device."""

    name: str
    hbm_gbps: float  # device-memory bandwidth, GB/s
    bf16_tflops: float  # dense bf16 tensor-core rate, TFLOP/s
    source: str


# keyed by jax.Device.device_kind
PEAKS: Dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(
        name="H100 SXM",
        hbm_gbps=3350.0,
        bf16_tflops=989.0,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense "
        "(no sparsity); rates assume the full 700 W power limit",
    ),
}


def peaks_for(device_kind: str) -> Peaks:
    """The peaks of `device_kind`; raises KeyError for a device that is not
    in PEAKS."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            f"data-sheet rates to utils/roofline.py PEAKS (known: "
            f"{sorted(PEAKS)})"
        ) from None


@dataclass
class StepCost:
    bytes_by: Dict[str, float] = field(default_factory=dict)
    flops_by: Dict[str, float] = field(default_factory=dict)
    gather_rows: float = 0.0

    def add_bytes(self, item: str, n: float):
        self.bytes_by[item] = self.bytes_by.get(item, 0.0) + float(n)

    def add_flops(self, item: str, n: float):
        self.flops_by[item] = self.flops_by.get(item, 0.0) + float(n)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by.values())

    @property
    def total_flops(self) -> float:
        return sum(self.flops_by.values())

    def bound_seconds(self, peaks: Peaks) -> Dict[str, float]:
        t_bytes = self.total_bytes / (peaks.hbm_gbps * 1e9)
        t_flops = self.total_flops / (peaks.bf16_tflops * 1e12)
        return {
            "t_bytes_ms": t_bytes * 1e3,
            "t_flops_ms": t_flops * 1e3,
            "sol_ms": max(t_bytes, t_flops) * 1e3,
            "binding": "bytes" if t_bytes >= t_flops else "flops",
        }


def _mlp_dims(mlp, in_dim, last_units=None):
    """[(in, out)] per Dense layer of an MLPSpec (point-wise kinds keep
    width). last_units overrides the LAST Dense layer, matching nn/mlp.py's
    actual parameter shapes."""
    dims = []
    d = in_dim
    layers = mlp.layers
    last_dense = max(
        (j for j, l in enumerate(layers) if l.kind == "Dense"), default=None
    )
    for j, l in enumerate(layers):
        if l.kind == "Dense":
            u = l.units
            if j == last_dense and last_units is not None:
                u = last_units
            dims.append((d, int(u)))
            d = int(u)
    return dims, d


def _param_count(model_ir) -> float:
    """Rough trainable-parameter count (Dense kernels + RNN cells)."""
    state = model_ir.state_dims()
    total = 0.0
    for stage in model_ir.stages:
        for mp in stage.passes:
            d = state[mp.destination]
            msg_dim = 0
            for src in mp.sources:
                in_dim = state[src.entity]
                cur = in_dim
                for op in src.ops:
                    if op.kind == "mlp":
                        dims, cur = _mlp_dims(op.mlp, cur)
                        total += sum(i * o + o for i, o in dims)
                msg_dim = max(msg_dim, cur)
            if mp.update.kind == "recurrent":
                g = 3 if mp.update.rnn.cell_type == "GRU" else 4
                total += g * d * (msg_dim + d + 2)
            else:
                dims, _ = _mlp_dims(mp.update.mlp, msg_dim + d, last_units=d)
                total += sum(i * o + o for i, o in dims)
    for op in model_ir.readout:
        if getattr(op, "mlp", None) is not None:
            in_dim = sum(state.get(x, state.get(model_ir.entity_names[0], 32))
                         for x in op.inputs)
            dims, _ = _mlp_dims(op.mlp, in_dim)
            total += sum(i * o + o for i, o in dims)
    return total


def train_step_cost(model_ir, meta, dtype_bytes: int = 2) -> StepCost:
    """Itemized mandatory bytes/FLOPs of one training step (conventions in
    the module docstring)."""
    from ..data.graph import (
        _DENSE_INC_MAX_ENTRIES, _DENSE_INC_MIN_EDGES, dense_agg_adjacencies,
    )
    from ..frontend.ir import is_slot_eligible, is_source_local

    c = StepCost()
    state = model_ir.state_dims()
    iters = model_ir.num_iterations
    b = dtype_bytes
    dense_adjs = dense_agg_adjacencies(model_ir)

    for stage in model_ir.stages:
        for mp in stage.passes:
            d_dst = state[mp.destination]
            n_d = meta.nodes(mp.destination)
            # concat is a sequence aggregation too (builder._SEQUENCE_AGGS:
            # the RNN runs over per-slot sequences) — review-found omission
            # that undercounted its RNN elements ~in-degree-fold
            seq_agg = mp.aggregation.kind in ("ordered", "interleave", "concat")
            concat2 = (
                mp.aggregation.kind == "concat"
                and mp.aggregation.concat_axis == 2
            )
            total_msg_elems = 0.0  # per-iteration RNN elements (ordered)
            final_dims = []  # per-source final message widths
            for src in mp.sources:
                E = meta.edges(src.adj_name)
                d_src = state[src.entity]
                n_s = meta.nodes(src.entity)
                local = is_source_local(src.ops)
                # dense-incidence eligibility (both data-layer gates: entry
                # cap AND the minimum edge count below which the matrix is
                # never emitted, graph.py _DENSE_INC_MIN_EDGES)
                dense_ok = (
                    local
                    and src.adj_name in dense_adjs
                    and E >= _DENSE_INC_MIN_EDGES
                    and (
                        src.adj_name in dict(meta.inc_blocks)
                        or n_d * n_s <= _DENSE_INC_MAX_ENTRIES
                    )
                )

                # message chain
                cur = d_src
                rows = n_s if local else E
                chain_in = d_src
                named_dims: Dict[str, int] = {}
                # slot-eligible per-edge chains (model/builder._slot_messages,
                # shared predicate frontend.ir.is_slot_eligible) evaluate
                # over the in-degree-sliced layout: ONE slice-map gather
                # (+ its sorted-segment-sum transpose) replaces the per-edge
                # input gathers, so their mandatory row movement is 2E per
                # iteration total, not per input stream
                slot_ok = is_slot_eligible(src.ops)
                for op in src.ops:
                    if op.kind == "mlp":
                        chain_in = sum(
                            state.get(mp.destination) if x == "hs_dest"
                            else (src.edge_param_dim or 0) if x == "edge_params"
                            else d_src if x == "hs_source"
                            # a previous op's named output (review-found:
                            # this used to charge the source STATE width)
                            else named_dims.get(x, d_src)
                            for x in op.inputs
                        ) or cur
                        dims, cur = _mlp_dims(op.mlp, chain_in)
                        if op.output_name:
                            named_dims[op.output_name] = cur
                        for (i, o) in dims:
                            c.add_flops("message_mlp", 3 * 2 * rows * i * o * iters)
                        # interior activations cross device memory
                        # (1 fwd + 2 bwd)
                        for (_i, o) in dims[:-1]:
                            c.add_bytes("message_acts", 3 * rows * o * b * iters)
                if not local:
                    # per-edge inputs must be gathered: the input stream and
                    # its cotangent are edge-rate
                    c.add_bytes("edge_stream", 3 * E * chain_in * b * iters)
                    if slot_ok and seq_agg:
                        pass  # the seq stream below IS the one slice gather
                    else:
                        c.gather_rows += 2 * E * iters
                msg_dim = cur
                final_dims.append(cur)

                if seq_agg:
                    # sequence consumption is inherently edge-slot-rate
                    # even for source-local messages: fwd read + bwd
                    # residual + bwd cotangent
                    c.add_bytes("seq_stream", 3 * E * msg_dim * b * iters)
                    c.gather_rows += 2 * E * iters
                    if concat2:
                        # axis-2 concat shares one slot grid across sources
                        # (features widen, slots do not) — counting each
                        # source's E would OVERcount RNN elements and break
                        # the lower-bound property
                        total_msg_elems = max(total_msg_elems, E)
                    else:
                        total_msg_elems += E
                elif local:
                    # commutative aggregation streaming from the node-rate
                    # message table: table read fwd + cotangent bwd
                    c.add_bytes("node_tables", 2 * n_s * msg_dim * b * iters)
                    if not dense_ok:
                        # without a dense/blocks incidence lowering (entry
                        # cap), the edge-rate message stream is gathered
                        # (fwd) and its cotangent routed back (bwd)
                        c.gather_rows += 2 * E * iters
                    else:
                        # the dense lowering reads the int8 incidence matrix
                        # once per pass: M @ s fwd and M^T @ ct bwd for a
                        # sum; the flash attention kernels read it three
                        # times (forward, dst- and src-backward). Blocks
                        # shrink it to the per-graph diagonal
                        blk = dict(meta.inc_blocks).get(src.adj_name)
                        entries = (
                            blk[0] * blk[1] * blk[2] if blk else n_d * n_s
                        )
                        reads = 3 if mp.aggregation.kind == "attention" else 2
                        c.add_bytes(
                            "dense_inc_matrix", entries * 1 * reads * iters
                        )

                # index companions (int32), fwd + bwd
                c.add_bytes("indices", 2 * E * 4 * iters)
                # aggregation adds
                c.add_flops("aggregation", 2 * E * msg_dim * iters)

                if mp.aggregation.kind == "attention":
                    # per-node score matmuls + width-1 edge score stream
                    c.add_flops("attention", 3 * 2 * (n_s + n_d) * d_dst
                                * d_dst * iters)
                    c.add_bytes("attention_scores", 3 * E * b * iters)
                elif mp.aggregation.kind == "convolution":
                    c.add_flops("convolution", 3 * 2 * n_s * d_src * d_dst
                                * iters)

            # update
            per_elem = 12 if mp.update.kind == "recurrent" and (
                mp.update.rnn.cell_type == "GRU"
            ) else 16
            if mp.update.kind == "recurrent" and seq_agg:
                # scanned (sequence) recurrent update: one cell step per
                # real message slot
                c.add_flops("rnn_update", 3 * per_elem * d_dst * d_dst
                            * total_msg_elems * iters)
            elif mp.update.kind == "recurrent":
                c.add_flops("rnn_update", 3 * per_elem * d_dst * d_dst
                            * n_d * iters)
            else:
                # the update consumes the AGGREGATED message, whose width is
                # the message chains' final output (review-found: the source
                # STATE dims were used, undercounting wide message MLPs)
                msg_dim = max(final_dims) if final_dims else d_dst
                dims, _ = _mlp_dims(mp.update.mlp, msg_dim + d_dst,
                                    last_units=d_dst)
                for (i, o) in dims:
                    c.add_flops("ff_update", 3 * 2 * n_d * i * o * iters)
            # updated state: written fwd, cotangent read bwd
            c.add_bytes("state_tables", 2 * n_d * d_dst * b * iters)

    # readout at domain row rate
    for op in model_ir.readout:
        if getattr(op, "mlp", None) is None:
            continue
        ent = next((x for x in op.inputs if x in state), None)
        rows = meta.nodes(ent) if ent else max(meta.label_pad, meta.num_graphs)
        in_dim = sum(state.get(x, 0) for x in op.inputs) or state.get(
            ent, 32
        )
        dims, _ = _mlp_dims(op.mlp, in_dim)
        for (i, o) in dims:
            c.add_flops("readout", 3 * 2 * rows * i * o)
        for (_i, o) in dims[:-1]:
            c.add_bytes("readout_acts", 3 * rows * o * b)

    # optimizer: p/m/v read+write + grad read, f32 master weights
    c.add_bytes("optimizer", 20 * _param_count(model_ir))
    return c


def roofline_report(model_ir, meta, measured_ms: float, device_kind: str,
                    dtype_bytes: int = 2) -> Dict[str, object]:
    """One dict per bench cell: itemized model + bound + achieved % of the
    published peaks of `device_kind` (KeyError if it has none)."""
    peaks = peaks_for(device_kind)
    c = train_step_cost(model_ir, meta, dtype_bytes)
    bounds = c.bound_seconds(peaks)
    return {
        "peaks": peaks.name,
        "bytes_mb": round(c.total_bytes / 1e6, 2),
        "gflops": round(c.total_flops / 1e9, 2),
        "t_bytes_ms": round(bounds["t_bytes_ms"], 3),
        "t_flops_ms": round(bounds["t_flops_ms"], 3),
        "sol_ms": round(bounds["sol_ms"], 3),
        "binding": bounds["binding"],
        "measured_ms": round(measured_ms, 3),
        "sol_pct": round(100.0 * bounds["sol_ms"] / measured_ms, 1)
        if measured_ms else None,
        "gather_rows_m": round(c.gather_rows / 1e6, 2),
        "bytes_items_mb": {k: round(v / 1e6, 2)
                           for k, v in sorted(c.bytes_by.items())},
        "flops_items_g": {k: round(v / 1e9, 2)
                          for k, v in sorted(c.flops_by.items())},
    }
