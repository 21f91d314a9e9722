"""Parallel training/inference steps over a ('data', 'model') mesh.

Two first-class strategies (absent from the reference, which is strictly
single-process — SURVEY §2.4):

  * **Graph-batch data parallelism** ('data' axis): each device gets one
    merged, identically-padded GraphBatch (stacked on a leading axis);
    gradients all-reduce with `psum`.
  * **Edge-partitioned model parallelism** ('model' axis): each adjacency's
    COO edge arrays are sharded along the edge dimension while node states
    stay replicated; every segment aggregation computes a local partial and
    all-reduces it (see ops/segment.py `axis_name`) — the boundary
    node-feature exchange of the edge-cut, expressed as XLA collectives.

Both compose: a 2-D mesh shards the stacked batch over 'data' and each
batch's edges over 'model'.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..data.graph import BatchMeta, infer_label_domain
from ..model.builder import GnnModel
from ..training.losses import loss_reduction

# --------------------------------------------------------------------------
# batch classification & stacking
# --------------------------------------------------------------------------


_warned_constant_rng: set = set()


def _warn_constant_rng(model) -> None:
    """Warn (once per model IR) when a stochastic model's train step is
    called without an rng: the PRNGKey(0) fallback reuses one dropout mask
    every step, silently degrading dropout to static masking
    (advisor-found, r4)."""
    kinds = model.ir.stochastic_layer_kinds()
    if kinds and id(model.ir) not in _warned_constant_rng:
        _warned_constant_rng.add(id(model.ir))
        import warnings

        warnings.warn(
            f"model contains stochastic layers {list(kinds)} but no rng was "
            f"passed to train_step; falling back to a CONSTANT PRNGKey(0) — "
            f"every step reuses the same dropout mask. Pass a fresh per-step "
            f"rng.",
            stacklevel=3,
        )


def edge_array_keys(model_ir) -> set:
    """Batch keys whose leading dimension is the edge axis of an adjacency."""
    keys = set()
    for a in model_ir.adjacency_info():
        for prefix in ("src_", "dst_", "seq_", "edge_mask_", "params_"):
            keys.add(prefix + a.name)
    for adj in model_ir.readout_adjacencies():
        for prefix in ("src_", "dst_", "seq_", "edge_mask_", "params_"):
            keys.add(prefix + adj)
    return keys


def stack_batches(
    batches: List[Tuple[Dict[str, np.ndarray], BatchMeta]],
    model_ir=None,
) -> Tuple[Dict[str, np.ndarray], BatchMeta]:
    """Stack merged batches on a new leading 'data' axis.

    Batches whose padded shapes differ are grown to a common meta first
    (requires `model_ir` for the re-pad)."""
    metas = {m for _, m in batches}
    if len(metas) != 1:
        if model_ir is None:
            raise ValueError(
                f"cannot stack batches with different shapes: {metas}; pass "
                f"model_ir so they can be re-padded to a common bucket"
            )
        from ..data.graph import merge_metas, repad_to_meta

        target = merge_metas([m for _, m in batches], model_ir)
        batches = [
            (repad_to_meta(arrays, m, target, model_ir), target)
            for arrays, m in batches
        ]
    arrays = {
        k: np.stack([b[k] for b, _ in batches], axis=0) for k in batches[0][0]
    }
    return arrays, batches[0][1]


# --------------------------------------------------------------------------
# sharded step builders
# --------------------------------------------------------------------------


def batch_partition_specs(
    model_ir,
    sample_batch: Dict[str, Any],
    data_axis: Optional[str] = "data",
    model_axis: Optional[str] = "model",
) -> Dict[str, P]:
    """PartitionSpec per batch key: leading stacked axis -> data_axis; edge
    arrays additionally shard their edge dimension over model_axis. Labels of
    edge-domain models (readouts through extend_adjacencies) live on the
    edge axis too, so they shard with it."""
    ekeys = set(edge_array_keys(model_ir))
    if infer_label_domain(model_ir)[0] == "edge":
        ekeys.update(("label", "label_mask", "label_perm"))
    specs = {}
    for k, v in sample_batch.items():
        dims: List[Optional[str]] = [data_axis]
        if k in ekeys:
            dims.append(model_axis)
        nd = np.ndim(v)
        while len(dims) < nd:
            dims.append(None)
        specs[k] = P(*dims[:nd]) if nd else P()
    return specs


def make_parallel_train_step(
    model: GnnModel,
    optimizer: optax.GradientTransformation,
    loss_fn: Callable,
    meta: BatchMeta,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = "model",
) -> Callable:
    """Build a jitted SPMD train step over `mesh`.

    Expects a stacked batch whose leading dim equals the data-axis size; each
    data shard runs the full GNN on its merged graph with its edge shards,
    using `model_axis` collectives inside aggregation; gradients psum over
    both axes.
    """
    n_data = mesh.shape[data_axis]
    use_model_axis = model_axis if (model_axis and mesh.shape.get(model_axis, 1) > 1) else None
    label_dom = infer_label_domain(model.ir)
    reduction = loss_reduction(loss_fn)

    def local_loss(params, stacked_local, key):
        # leading data dim is 1 on each shard
        batch = {k: v[0] for k, v in stacked_local.items()}
        # one REPLICATED dropout key: v1 recomputes node-level ops on every
        # model shard and those replicas must stay bit-identical, so the key
        # must not vary across shards (mask patterns therefore repeat per
        # shard block — valid dropout, just correlated draws)
        preds = model.apply(
            params, batch, meta, training=True, edge_axis=use_model_axis,
            rng=key,
        )
        if getattr(loss_fn, "takes_axis_names", False):
            # hinge-family: the all-binary label predicate must span the
            # whole effective batch, not each shard's slice
            axes = tuple(a for a in (data_axis, use_model_axis) if a)
            loss = loss_fn(batch["label"], preds, batch["label_mask"],
                           axis_names=axes)
        else:
            loss = loss_fn(batch["label"], preds, batch["label_mask"])
        if use_model_axis and label_dom[0] == "edge":
            # edge-domain predictions AND labels follow the sharded edge
            # arrays (extend_adjacencies gathers per local edge): combine
            # the local partial losses into the global one — mask-weighted
            # mean of means for mean-reduction losses, plain psum for
            # sum-reduction losses (keras KLDivergence); the psums keep
            # gradient flow purely local
            if reduction == "sum":
                loss = jax.lax.psum(loss, use_model_axis)
            else:
                cnt = jnp.sum(batch["label_mask"])
                loss = jax.lax.psum(loss * cnt, use_model_axis) / jnp.maximum(
                    jax.lax.psum(cnt, use_model_axis), 1.0
                )
        reg = model.regularization_loss(params)
        # Scale by 1/n_data: params enter the shard as a REPLICATED value, and
        # under shard_map's varying-mesh-axes semantics the cotangent of a
        # replicated input is automatically all-reduced across shards — the
        # returned grads are already sum-over-data-shards. Scaling the local
        # loss makes that sum the batch mean (sum-reduction losses keep the
        # plain sum: scale 1). Edge ('model') shards need no correction:
        # partial message-path contributions psum while the replicated
        # post-aggregation paths are tracked as one logical value.
        scale = 1.0 if reduction == "sum" else 1.0 / n_data
        return loss * scale + reg / n_data, loss

    def step(params, opt_state, stacked, key):
        (_, loss), grads = jax.value_and_grad(local_loss, has_aux=True)(
            params, stacked, key
        )
        if reduction == "sum":
            loss = jax.lax.psum(loss, data_axis)
        else:
            loss = jax.lax.pmean(loss, data_axis)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def build(stacked_batch):
        specs = batch_partition_specs(
            model.ir, stacked_batch, data_axis, model_axis if use_model_axis else None
        )
        in_batch_specs = {k: specs[k] for k in stacked_batch}
        sharded = shard_map(
            step,
            mesh=mesh,
            in_specs=(P(), P(), in_batch_specs, P()),
            out_specs=(P(), P(), P()),
        )
        return jax.jit(sharded)

    cache: Dict[Tuple, Callable] = {}

    def train_step(params, opt_state, stacked_batch, rng=None):
        # rng: per-step dropout key (review-found: the sharded paths used
        # to drop it, crashing dropout models at trace time). Callers
        # without dropout may omit it.
        if rng is None:
            _warn_constant_rng(model)
            rng = jax.random.PRNGKey(0)
        key = tuple(sorted((k, np.shape(v)) for k, v in stacked_batch.items()))
        if key not in cache:
            cache[key] = build(stacked_batch)
        if jax.process_count() > 1:
            # multi-host: each process holds its local slice of the 'data'
            # axis; assemble global arrays before the jitted sharded step
            specs = batch_partition_specs(
                model.ir,
                stacked_batch,
                data_axis,
                model_axis if use_model_axis else None,
            )
            stacked_batch = _globalize(
                stacked_batch, mesh, {k: specs[k] for k in stacked_batch}
            )
            params = _globalize_replicated(params, mesh)
            opt_state = _globalize_replicated(opt_state, mesh)
            rng = _globalize_replicated(rng, mesh)
        return cache[key](params, opt_state, stacked_batch, rng)

    return train_step


def _globalize(tree, mesh, specs_tree):
    """Host-local arrays -> global jax.Arrays laid out per `specs_tree`
    (multi-host only; sharded axes concatenate across processes)."""
    from jax.experimental import multihost_utils as mh

    return mh.host_local_array_to_global_array(tree, mesh, specs_tree)


def _globalize_replicated(tree, mesh):
    """Replicated pytree -> global arrays; leaves that are already global
    (e.g. outputs of the previous step) pass through."""
    n_global = mesh.devices.size

    def one(x):
        if isinstance(x, jax.Array) and len(x.sharding.device_set) == n_global:
            return x
        from jax.experimental import multihost_utils as mh

        return mh.host_local_array_to_global_array(x, mesh, P())

    return jax.tree.map(one, tree)


def make_parallel_apply(
    model: GnnModel,
    meta: BatchMeta,
    mesh: Mesh,
    data_axis: str = "data",
    model_axis: Optional[str] = "model",
) -> Callable:
    """Sharded forward: stacked batch in, stacked predictions out."""
    use_model_axis = model_axis if (model_axis and mesh.shape.get(model_axis, 1) > 1) else None
    label_dom = infer_label_domain(model.ir)

    def fwd(params, stacked_local):
        batch = {k: v[0] for k, v in stacked_local.items()}
        preds = model.apply(params, batch, meta, edge_axis=use_model_axis)
        if use_model_axis and label_dom[0] == "edge":
            # local edge shards -> global edge order (forward only, no AD)
            preds = jax.lax.all_gather(
                preds, use_model_axis, axis=0, tiled=True
            )
        return preds[None]

    cache: Dict[Tuple, Callable] = {}

    def apply_fn(params, stacked_batch):
        key = tuple(sorted((k, np.shape(v)) for k, v in stacked_batch.items()))
        if key not in cache:
            specs = batch_partition_specs(
                model.ir, stacked_batch, data_axis, use_model_axis
            )
            in_specs = {k: specs[k] for k in stacked_batch}
            sharded = shard_map(
                fwd,
                mesh=mesh,
                in_specs=(P(), in_specs),
                out_specs=P(data_axis),
            )
            cache[key] = jax.jit(sharded)
        return cache[key](params, stacked_batch)

    return apply_fn
