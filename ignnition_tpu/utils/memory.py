"""Analytic device-memory footprint estimate for one training step.

Answers "does this graph fit on one device, and if not, how many
destination shards does it need?" — the capability statement behind
edgeshard v2's motivating case (docs/scaling.md 'a single graph too large
for one device'). Itemization:

  * params: ~20 B/param — f32 master weights + Adam slots (m, v) + the
    gradient tree + transient bf16 compute casts;
  * batch: the device-resident batch arrays (pass the exact
    `sum(v.nbytes)` when the batch exists; estimated from BatchMeta
    otherwise);
  * residuals: AD-saved activations, the dominant term at scale — per MP
    iteration each sequence update saves its [L, n_dst, D] time slices
    (plus the remat scan's per-step carries), each per-edge chain its
    [E, units] interior activations, and every entity its per-iteration
    state table;
  * workspace: transient fusion scratch, ~2x the largest live edge-rate
    tensor.

The model is deliberately simple and padded-shape based (BatchMeta), like
the roofline. Capacity is what the device's allocator reports it may use
(`memory_stats()["bytes_limit"]`); it is not yet validated against a
measured out-of-memory boundary on the GPU.
"""

from __future__ import annotations

from typing import Dict, Optional


def device_capacity_bytes(device=None) -> Optional[int]:
    """Bytes the device's allocator may use, or None for a device that
    reports no memory statistics (the CPU)."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return int(stats["bytes_limit"]) if stats and "bytes_limit" in stats else None


def estimate_train_hbm(
    model_ir,
    meta,
    batch_bytes: Optional[float] = None,
    dtype_bytes: int = 2,
) -> Dict[str, float]:
    from .roofline import _mlp_dims, _param_count

    b = dtype_bytes
    state = model_ir.state_dims()
    iters = model_ir.num_iterations

    params_bytes = 20.0 * _param_count(model_ir)

    if batch_bytes is None:
        # features + labels + per-edge index companions (~6 int32 vectors
        # per adjacency counting src/dst/seq + CSR/slice companions)
        batch_bytes = 0.0
        for e in model_ir.entities:
            n = meta.nodes(e.name)
            batch_bytes += n * sum(f.size for f in e.features) * 4
        for info in model_ir.adjacency_info():
            E = meta.edges(info.name)
            batch_bytes += 6 * E * 4
            batch_bytes += E * (info.edge_param_dim or 0) * 4
        batch_bytes += max(meta.label_pad, 1) * 8

    residual = 0.0
    for stage in model_ir.stages:
        for mp in stage.passes:
            d_dst = state[mp.destination]
            n_d = meta.nodes(mp.destination)
            seq_agg = mp.aggregation.kind in ("ordered", "interleave", "concat")
            for src in mp.sources:
                E = meta.edges(src.adj_name)
                d_src = state[src.entity]
                if seq_agg:
                    # [L, n_dst, D] time slices saved for the backward +
                    # the remat scan's per-step carry residuals (~same size)
                    L = dict(meta.max_len).get(src.adj_name) or 1
                    residual += 2 * L * n_d * d_dst * b * iters
                else:
                    # edge-rate message stream saved once per iteration
                    residual += E * max(d_src, d_dst) * b * iters
                # per-edge MLP interior activations
                cur = d_src
                for op in src.ops:
                    if op.kind == "mlp":
                        dims, cur = _mlp_dims(op.mlp, cur)
                        for (_i, o) in dims[:-1]:
                            residual += E * o * b * iters
    for e in model_ir.entities:
        residual += meta.nodes(e.name) * state[e.name] * b * iters

    # dense incidence matrices (block or full), live per iteration's
    # backward when the dense lowering applies
    from ..data.graph import (
        _DENSE_INC_MAX_ENTRIES, _DENSE_INC_MIN_EDGES, dense_agg_adjacencies,
    )

    dense_adjs = dense_agg_adjacencies(model_ir)
    inc_blocks = dict(meta.inc_blocks)
    dense_bytes = 0.0
    for info in model_ir.adjacency_info():
        if info.name not in dense_adjs:
            continue
        if meta.edges(info.name) < _DENSE_INC_MIN_EDGES:
            continue
        blk = inc_blocks.get(info.name)
        entries = (
            blk[0] * blk[1] * blk[2] if blk
            else meta.nodes(info.dst) * meta.nodes(info.src)
        )
        if blk is None and entries > _DENSE_INC_MAX_ENTRIES:
            continue  # the data layer never emits the matrix above the cap
        dense_bytes += entries * b

    # transient fusion scratch: ~2x the largest edge-rate tensor
    biggest = 0.0
    for info in model_ir.adjacency_info():
        E = meta.edges(info.name)
        d = max(state[info.src], state[info.dst])
        biggest = max(biggest, E * d * b)
    workspace = 2.0 * biggest

    total = params_bytes + batch_bytes + residual + dense_bytes + workspace
    return {
        "params_bytes": params_bytes,
        "batch_bytes": float(batch_bytes),
        "residual_bytes": residual,
        "dense_inc_bytes": dense_bytes,
        "workspace_bytes": workspace,
        "total_bytes": total,
    }


def recommended_shards(total_bytes: float, capacity_bytes: float) -> int:
    """Destination shards (edgeshard v2 'model' axis) needed so each shard's
    share of `total_bytes` fits in `capacity_bytes`. 1 = fits on one
    device."""
    m = 1
    while total_bytes / m > capacity_bytes and m < 4096:
        m *= 2
    return m


def maybe_warn_capacity(model_ir, meta, batch_bytes=None, log=None,
                        capacity_bytes=None) -> int:
    """Estimate the footprint and warn when one device likely cannot hold
    it; returns the recommended shard count (1 = fits). Capacity defaults
    to the default device's; a device without memory statistics is never
    warned about."""
    capacity = capacity_bytes or device_capacity_bytes()
    if capacity is None:
        return 1
    est = estimate_train_hbm(model_ir, meta, batch_bytes=batch_bytes)
    m = recommended_shards(est["total_bytes"], capacity)
    if m > 1 and log is not None:
        log.warning(
            "estimated training footprint %.1f GB exceeds the device's "
            "%.1f GB: consider mesh + model_strategy='dest_shard' over "
            ">=%d shards (docs/scaling.md)",
            est["total_bytes"] / 1e9, capacity / 1e9, m,
        )
    return m
