"""Exact-parity test: native (C++) adjacency index companions vs the numpy
reference implementation in data/graph.py."""

import numpy as np
import pytest

from ignnition_tpu.data import graph as G
from ignnition_tpu.data import native_loader as NL
from tests.test_fast_backward import _random_adjacency

# the session fixture builds the library (make -C native) first
pytestmark = pytest.mark.usefixtures("native_loader")


def _both(src, dst, emask, n_src_pad, n_dst_pad, max_len, bwd_len=None):
    native = NL.adjacency_aux_native(
        src, dst, emask, n_src_pad, n_dst_pad, max_len,
        -1 if bwd_len is None else bwd_len, G._SLICE_SORT_CHUNK,
    )
    assert native is not None
    orig = G._USE_NATIVE_AUX
    G._USE_NATIVE_AUX = False
    try:
        ref = G.adjacency_aux_arrays(
            src, dst, emask, n_src_pad, n_dst_pad, max_len, bwd_len=bwd_len
        )
    finally:
        G._USE_NATIVE_AUX = orig
    return native, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "n_src,n_dst,e_real,e_pad,n_src_pad,n_dst_pad,max_len",
    [
        (37, 23, 180, 192, 40, 24, 8),
        (5, 400, 900, 1024, 8, 512, 4),  # hub sources: no bwd_slice
        (100, 7, 60, 64, 128, 8, 12),
    ],
)
def test_native_matches_numpy(seed, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad, max_len):
    rng = np.random.default_rng(seed)
    src, dst, seq, emask = _random_adjacency(
        rng, n_src, n_dst, e_real, e_pad, n_src_pad, n_dst_pad
    )
    native, ref = _both(src, dst, emask, n_src_pad, n_dst_pad, max_len)
    assert set(native) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(
            np.asarray(native[k]), np.asarray(ref[k]), err_msg=k
        )
        assert native[k].dtype == ref[k].dtype, k


def test_native_fixed_bwd_len_and_empty():
    rng = np.random.default_rng(9)
    src, dst, seq, emask = _random_adjacency(rng, 10, 10, 40, 48, 12, 12)
    native, ref = _both(src, dst, emask, 12, 12, 4, bwd_len=8)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(native[k]), np.asarray(ref[k]), err_msg=k)
    # all-padding edge list
    e = np.zeros(16, np.float32)
    s = np.full(16, 11, np.int32)
    d = np.full(16, 11, np.int32)
    native, ref = _both(s, d, e, 12, 12, 4)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(native[k]), np.asarray(ref[k]), err_msg=k)


def test_multi_window_slice_sort_parity(monkeypatch):
    """Force multiple slice-sort windows by shrinking the chunk size."""
    rng = np.random.default_rng(4)
    src, dst, seq, emask = _random_adjacency(rng, 37, 230, 1800, 2048, 40, 256)
    monkeypatch.setattr(G, "_SLICE_SORT_CHUNK", 300)
    native, ref = _both(src, dst, emask, 40, 256, 8)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(native[k]), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("chunk", [300, 10**9])
def test_native_slice_sort_matches_numpy(chunk, monkeypatch):
    rng = np.random.default_rng(21)
    n_src_pad = 40
    slice_src = rng.integers(0, n_src_pad, size=(16, 256)).astype(np.int32)
    native = NL.slice_sort_native(slice_src, n_src_pad, chunk)
    assert native is not None
    monkeypatch.setattr(G, "_SLICE_SORT_CHUNK", chunk)
    monkeypatch.setattr(G, "_USE_NATIVE_AUX", False)
    ref = G.slice_sort_companions(slice_src, n_src_pad)
    assert set(native) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(native[k]), np.asarray(ref[k]), err_msg=k)
        assert native[k].dtype == ref[k].dtype, k


def test_native_slice_sort_rejects_out_of_range():
    bad = np.array([[0, 50]], np.int32)  # 50 >= n_src_pad
    assert NL.slice_sort_native(bad, 40, 1000) is None
