"""Packed batch transfer: ship a GraphBatch to the device as one buffer
per dtype instead of one transfer per array.

A merged GraphBatch is a dict of ~40 small arrays (features, edge lists,
masks, index companions). Host->device transfer can charge a fixed
per-array cost that dwarfs the bytes at streaming batch sizes (not
measured on the GPU). Packing concatenates all arrays of a dtype into one flat
host buffer; the jitted step unpacks with STATIC slices + reshapes, which
XLA fuses into the consumers — the device-side unpack is free.

The layout is a pure function of the batch's (key, dtype, shape) signature,
i.e. of its BatchMeta, so jit caches key on it naturally.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

# layout: ((key, dtype_name, start, shape), ...) sorted by key — hashable,
# usable as part of a jit-step cache key
Layout = Tuple[Tuple[str, str, int, Tuple[int, ...]], ...]


def _np_dtype(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:  # extension dtypes (bfloat16, ...) live in ml_dtypes
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))


def pack_layout(arrays: Mapping[str, np.ndarray]) -> Layout:
    """Compute the packed layout for a batch signature (any batch with the
    same keys/dtypes/shapes — i.e. the same BatchMeta — shares it)."""
    sizes: Dict[str, int] = {}
    out = []
    for k in sorted(arrays):
        v = np.asarray(arrays[k])
        g = np.dtype(v.dtype).name
        start = sizes.get(g, 0)
        out.append((k, g, start, tuple(v.shape)))
        sizes[g] = start + v.size
    return tuple(out)


def pack_arrays(
    arrays: Mapping[str, np.ndarray], layout: Layout
) -> Dict[str, np.ndarray]:
    """One flat host buffer per dtype (host cost: one memcpy per array)."""
    sizes: Dict[str, int] = {}
    for _, g, start, shape in layout:
        sizes[g] = max(sizes.get(g, 0), start + int(np.prod(shape, dtype=np.int64)))
    bufs = {g: np.empty(n, dtype=_np_dtype(g)) for g, n in sizes.items()}
    for k, g, start, shape in layout:
        v = np.asarray(arrays[k])
        bufs[g][start : start + v.size] = v.reshape(-1)
    return {f"packed{g}": b for g, b in bufs.items()}


def unpack_arrays(bufs: Mapping[str, "object"], layout: Layout) -> Dict[str, "object"]:
    """Static slices + reshapes (trace-time constants; XLA fuses them away).
    Works on device (jnp) and host (numpy) arrays alike."""
    out = {}
    for k, g, start, shape in layout:
        n = int(np.prod(shape, dtype=np.int64))
        out[k] = bufs[f"packed{g}"][start : start + n].reshape(shape)
    return out
