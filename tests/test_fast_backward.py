"""Gradient parity of the host-indexed fast backward paths.

The fused direct-assignation ops carry hand-written VJPs driven by
host-precomputed index companions (windowed slice sorts, bounded out-degree
slice maps). These tests pit each custom VJP against plain JAX autodiff on
masked reference formulations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ignnition_tpu.data import graph as G
from ignnition_tpu.ops import segment as seg


def _random_adjacency(rng, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad):
    src = rng.integers(0, n_src, e_real).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst, e_real)).astype(np.int32)
    src_full = np.concatenate([src, np.full(e_pad - e_real, n_src_pad - 1, np.int32)])
    dst_full = np.concatenate([dst, np.full(e_pad - e_real, n_dst_pad - 1, np.int32)])
    emask = np.zeros(e_pad, np.float32)
    emask[:e_real] = 1.0
    seq = np.zeros(e_pad, np.int32)
    for d in range(n_dst_pad):
        idx = np.where(dst_full == d)[0]
        seq[idx] = np.arange(len(idx))
    return src_full, dst_full, seq, emask


def test_direct_segment_sum_sliced_grad_matches_autodiff():
    rng = np.random.default_rng(3)
    n_src, n_dst, e_real = 37, 23, 180
    n_src_pad, n_dst_pad, e_pad = 40, 24, 192
    src, dst, seq, emask = _random_adjacency(
        rng, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad
    )
    aux = G.adjacency_aux_arrays(src, dst, emask, n_src_pad, n_dst_pad, max_len=8)
    assert "bwd_slice_dst" in aux  # bounded out-degree on this size

    states = jnp.asarray(rng.standard_normal((n_src_pad, 8)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((n_dst_pad, 8)), jnp.float32)

    def fast(s):
        out = seg.direct_segment_sum_sliced(
            s,
            jnp.asarray(src),
            jnp.asarray(dst),
            jnp.asarray(emask),
            jnp.asarray(aux["bwd_slice_dst"]),
            jnp.asarray(aux["out_lens"]),
            n_dst_pad,
            n_src_pad,
        )
        return jnp.sum(out * w)

    def ref(s):
        m = s[jnp.asarray(src)] * jnp.asarray(emask)[:, None]
        out = jax.ops.segment_sum(m, jnp.asarray(dst), n_dst_pad)
        return jnp.sum(out * w)

    g_fast = jax.grad(fast)(states)
    g_ref = jax.grad(ref)(states)
    np.testing.assert_allclose(np.asarray(g_fast), np.asarray(g_ref), atol=1e-5)
    np.testing.assert_allclose(float(fast(states)), float(ref(states)), rtol=1e-5)


def test_gather_state_slices_windowed_grad_matches_autodiff(monkeypatch):
    # force multiple sort windows on a small problem
    monkeypatch.setattr(G, "_SLICE_SORT_CHUNK", 64)
    rng = np.random.default_rng(5)
    n_src, n_dst, e_real = 19, 41, 160
    n_src_pad, n_dst_pad, e_pad = 24, 48, 192
    src, dst, seq, emask = _random_adjacency(
        rng, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad
    )
    max_len = 8
    aux = G.adjacency_aux_arrays(src, dst, emask, n_src_pad, n_dst_pad, max_len)
    n_slots = max_len * n_dst_pad
    assert aux["slice_sort_row_ptr"].shape[0] > n_src_pad + 1  # >1 window

    states = jnp.asarray(rng.standard_normal((n_src_pad, 4)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((max_len, n_dst_pad, 4)), jnp.float32)

    def fast(s):
        xs = seg.gather_state_slices(
            s,
            jnp.asarray(aux["slice_src"]),
            jnp.asarray(aux["slice_sort_perm"]),
            jnp.asarray(aux["slice_sort_ids"]),
            jnp.asarray(aux["slice_sort_row_ptr"]),
        )
        return jnp.sum(xs * w)

    def ref(s):
        return jnp.sum(s[jnp.asarray(aux["slice_src"])] * w)

    np.testing.assert_allclose(float(fast(states)), float(ref(states)), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jax.grad(fast)(states)),
        np.asarray(jax.grad(ref)(states)),
        atol=1e-5,
    )


def test_merge_metas_bwd_len_rules():
    base = dict(
        num_graphs=1,
        node_pad=(("a", 8),),
        edge_pad=(("e", 16),),
        max_len=(("e", 4),),
    )
    m1 = G.BatchMeta(bwd_len=(("e", 8),), **base)
    m2 = G.BatchMeta(bwd_len=(("e", 12),), **base)
    m3 = G.BatchMeta(bwd_len=(("e", 0),), **base)
    assert dict(G.merge_metas([m1, m2]).bwd_len)["e"] == 12
    # any opt-out (unbounded out-degree) disables the slice map for the merge
    assert dict(G.merge_metas([m1, m3]).bwd_len)["e"] == 0
    assert dict(G.merge_metas([m3, m2]).bwd_len)["e"] == 0


def test_repad_regenerates_bwd_slice_to_target():
    import types

    rng = np.random.default_rng(7)

    # minimal fake IR surface used by repad_to_meta
    class _Adj:
        def __init__(self):
            self.name = "e"
            self.src = "a"
            self.dst = "b"
            self.has_params = False
            self.edge_param_dim = 0

    class _IR:
        def adjacency_info(self):
            return [_Adj()]

        def all_passes(self):
            return []

        stages = ()

        @property
        def entities(self):
            return []

    n_src_pad, n_dst_pad, e_pad, e_real = 16, 16, 32, 30
    src, dst, seq, emask = _random_adjacency(
        rng, 14, 14, e_real, e_pad, n_src_pad, n_dst_pad
    )
    aux = G.adjacency_aux_arrays(src, dst, emask, n_src_pad, n_dst_pad, 8)
    arrays = {"src_e": src, "dst_e": dst, "seq_e": seq, "edge_mask_e": emask}
    arrays.update({f"{k}_e": v for k, v in aux.items()})
    meta = G.BatchMeta(
        num_graphs=1,
        node_pad=(("a", n_src_pad), ("b", n_dst_pad)),
        edge_pad=(("e", e_pad),),
        max_len=(("e", 8),),
        bwd_len=(("e", aux["bwd_slice_dst"].shape[0]),),
    )
    target = G.BatchMeta(
        num_graphs=1,
        node_pad=(("a", n_src_pad), ("b", n_dst_pad)),
        edge_pad=(("e", e_pad + 32),),
        max_len=(("e", 8),),
        bwd_len=(("e", aux["bwd_slice_dst"].shape[0] + 4),),
    )
    out = G.repad_to_meta(arrays, meta, target, _IR())
    assert out["bwd_slice_dst_e"].shape == (
        aux["bwd_slice_dst"].shape[0] + 4,
        n_src_pad,
    )
    # padding edges moved with the grown edge list; suffix invariant holds
    assert np.all(out["src_e"][e_real:] == n_src_pad - 1)
    assert np.all(out["dst_e"][e_real:] == n_dst_pad - 1)
