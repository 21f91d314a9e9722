"""Recurrent cells (GRU / LSTM) and the masked sequence update.

Functional equivalents of the reference's `Recurrent_Cell`
(auxilary_classes.py:702-796), which wraps `tf.keras.layers.{GRU,LSTM}Cell`:

  * `cell_step`  — one cell application (the reference's
    `perform_unsorted_update`, a_c.py:752-765): used after sum/attention/
    convolution aggregations, where the aggregated message is a single vector.
  * `masked_update` — a `lax.scan` over the padded per-destination message
    sequence `[num_dst, max_len, dim]` with a length mask, returning the state
    after the last valid step (the reference's `perform_sorted_update`,
    a_c.py:767-796, which runs a masked Keras RNN and gathers
    `outputs[:, final_len-1]`). Masked steps carry the state through, so the
    final carry equals the reference's gathered output; destinations with zero
    messages keep their previous state (the reference would index -1 there —
    RouteNet-style data never exercises it).

GRU follows the Keras v2 formulation with `reset_after=True` (two bias sets,
the cuDNN-compatible variant that is the TF2 default); LSTM uses
`unit_forget_bias=True`. Initializers match Keras defaults
(glorot_uniform kernel, orthogonal recurrent, zero bias).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..frontend.ir import RNNSpec
from .layers import glorot_uniform, orthogonal

# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init(rng: jax.Array, spec: RNNSpec, in_dim: int, units: int) -> Dict[str, Any]:
    k1, k2 = jax.random.split(rng)
    if spec.cell_type == "GRU":
        return {
            "kernel": glorot_uniform(k1, (in_dim, 3 * units)),
            "recurrent_kernel": orthogonal(k2, (units, 3 * units)),
            "bias": jnp.zeros((2, 3 * units), jnp.float32),  # input & recurrent
        }
    if spec.cell_type == "LSTM":
        bias = jnp.zeros((4 * units,), jnp.float32)
        # unit_forget_bias: forget-gate bias starts at 1 (Keras default)
        bias = bias.at[units : 2 * units].set(1.0)
        return {
            "kernel": glorot_uniform(k1, (in_dim, 4 * units)),
            "recurrent_kernel": orthogonal(k2, (units, 4 * units)),
            "bias": bias,
        }
    raise ValueError(f"unknown recurrent cell type '{spec.cell_type}'")


# --------------------------------------------------------------------------
# single step
# --------------------------------------------------------------------------


def _gru_step(params, x, h):
    units = h.shape[-1]
    xw = x @ params["kernel"] + params["bias"][0]
    hw = h @ params["recurrent_kernel"] + params["bias"][1]
    xz, xr, xh = jnp.split(xw, 3, axis=-1)
    hz, hr, hh = jnp.split(hw, 3, axis=-1)
    z = jax.nn.sigmoid(xz + hz)
    r = jax.nn.sigmoid(xr + hr)
    hcand = jnp.tanh(xh + r * hh)
    return z * h + (1.0 - z) * hcand


def _lstm_step(params, x, state):
    h, c = state
    zw = x @ params["kernel"] + h @ params["recurrent_kernel"] + params["bias"]
    i, f, g, o = jnp.split(zw, 4, axis=-1)
    i = jax.nn.sigmoid(i)
    f = jax.nn.sigmoid(f)
    g = jnp.tanh(g)
    o = jax.nn.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * jnp.tanh(c_new)
    return h_new, c_new


def cell_step(spec: RNNSpec, params, x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """One cell application. `h` is the visible state (LSTM keeps its cell
    state internal to a sequence; for single-step updates the reference also
    passes only `[old_state]` as initial state, zero cell state)."""
    if spec.cell_type == "GRU":
        return _gru_step(params, x, h)
    h_new, _ = _lstm_step(params, x, (h, jnp.zeros_like(h)))
    return h_new


# --------------------------------------------------------------------------
# masked sequence update
# --------------------------------------------------------------------------


def masked_update(
    spec: RNNSpec,
    params,
    seq_inputs: jnp.ndarray,  # [num_dst, max_len, dim]
    lengths: jnp.ndarray,  # [num_dst] int
    init_state: jnp.ndarray,  # [num_dst, units]
) -> jnp.ndarray:
    """Run the cell over the time axis; masked steps carry state through.

    Returns the state after each destination's last valid message.
    """
    max_len = seq_inputs.shape[1]
    t_index = jnp.arange(max_len)

    if spec.cell_type == "GRU":

        def body(h, xt):
            x, valid = xt
            h_new = _gru_step(params, x, h)
            h = jnp.where(valid[:, None], h_new, h)
            return h, None

        xs = (jnp.moveaxis(seq_inputs, 1, 0), (t_index[:, None] < lengths[None, :]))
        final, _ = jax.lax.scan(body, init_state, xs)
        return final

    def body(carry, xt):
        h, c = carry
        x, valid = xt
        h_new, c_new = _lstm_step(params, x, (h, c))
        h = jnp.where(valid[:, None], h_new, h)
        c = jnp.where(valid[:, None], c_new, c)
        return (h, c), None

    xs = (jnp.moveaxis(seq_inputs, 1, 0), (t_index[:, None] < lengths[None, :]))
    (final_h, _), _ = jax.lax.scan(body, (init_state, jnp.zeros_like(init_state)), xs)
    return final_h


@functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
def gather_time_slices(messages, row_ptr, seq, dst, max_len):
    """[L, num_dst, dim] time slices of a destination-sorted edge-message
    array: slice t row d = messages[row_ptr[d] + t] (clamped).

    Custom VJP: the transpose of these L gathers is a single flat gather
    ct_messages[e] = ct[seq[e], dst[e]] — every real edge is read by exactly
    one valid (t, d) slot, invalid slots receive zero cotangent from the
    masked scan, and padding edges' spurious credits are annihilated by the
    upstream edge-mask multiply. Without this, AD emits one scatter-add per
    scan step.
    """
    e = messages.shape[0]
    idx = jnp.minimum(
        row_ptr[None, :] + jnp.arange(max_len)[:, None], e - 1
    )  # [L, num_dst]
    return messages[idx]


def _gts_fwd(messages, row_ptr, seq, dst, max_len):
    out = gather_time_slices(messages, row_ptr, seq, dst, max_len)
    return out, (seq, dst)


def _gts_bwd(max_len, res, ct):
    seq, dst = res
    l, n, d = ct.shape
    flat = ct.reshape(l * n, d)
    ct_msg = flat[jnp.minimum(seq, l - 1) * n + dst]
    return ct_msg, None, None, None


gather_time_slices.defvjp(_gts_fwd, _gts_bwd)


def masked_update_from_edges(
    spec: RNNSpec,
    params,
    messages: jnp.ndarray,  # [E, dim] destination-sorted, seq-ascending
    row_ptr: jnp.ndarray,  # [num_dst] first edge index of each destination
    seq: jnp.ndarray,  # [E] per-destination sequence positions
    dst: jnp.ndarray,  # [E] destination ids
    lengths: jnp.ndarray,  # [num_dst] real message count per destination
    init_state: jnp.ndarray,  # [num_dst, units]
    max_len: int,
) -> jnp.ndarray:
    """Ordered recurrent update WITHOUT materializing the padded
    [num_dst, max_len, dim] sequence tensor.

    Because the data layer emits destination-sorted COO with ascending
    per-destination sequence positions, destination d's t-th message is
    simply `messages[row_ptr[d] + t]` — gathered per time slice (see
    gather_time_slices) instead of the reference-shaped padded scatter
    (generate_model.py:477-491). Masked steps carry
    state through.
    """
    xs = gather_time_slices(messages, row_ptr, seq, dst, max_len)  # [L, N, D]
    return masked_update_stacked(spec, params, xs, lengths, init_state)


def masked_update_stacked(
    spec: RNNSpec,
    params,
    xs: jnp.ndarray,  # [max_len, num_dst, dim] time-major slices
    lengths: jnp.ndarray,  # [num_dst]
    init_state: jnp.ndarray,  # [num_dst, units]
    step_fn=None,  # optional per-slice transform applied inside the body
) -> jnp.ndarray:
    """Masked recurrent scan over time-major input slices.

    The step body is rematerialized (jax.checkpoint): without it, scan AD
    stacks every gate tensor per time step ([L, N, 3*units] x several) into
    device memory on the forward and reads them back on the backward — recomputing the
    two small gate matmuls is far cheaper than that traffic.

    step_fn (r5): an optional [num_dst, dim] -> [num_dst, dim'] transform
    run on each time slice INSIDE the (rematerialized) body — the slot-MLP
    tail rides this so the scan consumes gather-produced pre-activations
    directly. Rationale: a tail matmul applied to the whole [L*N, H] (or
    [L, N, H]) tensor is emitted by XLA in a batch-in-lanes layout that
    forces a full-tensor layout COPY into the scan (measured 1.4 ms/step in
    the mlp_message family); per-slice tails inside the body fuse with the
    gate matmuls, and remat also drops the tail's interior activations from
    the residual stack. Exact: same math per real slot, masked slots are
    ignored by the length mask.
    """
    t_index = jnp.arange(xs.shape[0])

    if spec.cell_type == "GRU":

        @jax.checkpoint
        def body(h, xt):
            x, t = xt
            if step_fn is not None:
                x = step_fn(x)
            valid = t < lengths
            h_new = _gru_step(params, x, h)
            h = jnp.where(valid[:, None], h_new, h)
            return h, None

        final, _ = jax.lax.scan(
            body, init_state, (xs, t_index), unroll=_scan_unroll()
        )
        return final

    @jax.checkpoint
    def body(carry, xt):
        h, c = carry
        x, t = xt
        if step_fn is not None:
            x = step_fn(x)
        valid = t < lengths
        h_new, c_new = _lstm_step(params, x, (h, c))
        h = jnp.where(valid[:, None], h_new, h)
        c = jnp.where(valid[:, None], c_new, c)
        return (h, c), None

    (final_h, _), _ = jax.lax.scan(
        body, (init_state, jnp.zeros_like(init_state)), (xs, t_index),
        unroll=_scan_unroll(),
    )
    return final_h


def _scan_unroll() -> int:
    """Time-axis unroll of the masked update scans (per-step launch
    overhead amortizes over k cell steps per scan step). Read at trace
    time; r4.2 measured flat for the direct flagship, re-probed in r5
    with the in-body tail — default stays 1 unless a probe wins."""
    import os

    return int(os.environ.get("IGNNITION_TPU_SCAN_UNROLL", "1"))
