"""Triangle clustering (flattened median-split BVH) for large mesh scenes.

The reference has no GPU acceleration structure at all (its AABB groups are
CPU-only culling, SURVEY.md quirk 1); at mesh scale (BASELINE config 3) the
brute-force sweep is O(N) per ray.  Triangles are reordered into spatially
coherent clusters of ``leaf_size`` (median splits on the widest centroid
axis — a BVH cut at fixed depth), each with its AABB: the data a BVH
traversal reads.  The intersection is still brute force; nothing reads the
clusters yet.

The builder prefers the native C++ implementation (csrc/pt_runtime.cc) and
falls back to this pure-numpy equivalent; both produce identical layouts.
"""
from __future__ import annotations

import numpy as np


def build_clusters_py(tris9: np.ndarray, leaf_size: int = 16):
    """Pure-numpy median-split clusters; same layout as the C++ builder:
    returns (order (N,), aabbs (M, 6) [min3,max3], ranges (M, 2) [start, count]).
    """
    tris9 = np.asarray(tris9, np.float32).reshape(-1, 9)
    n = tris9.shape[0]
    v = tris9.reshape(n, 3, 3)
    cent = v.mean(axis=1)
    order = np.arange(n)
    aabbs, ranges = [], []

    def rec(lo: int, hi: int):
        if hi - lo <= leaf_size:
            t = v[order[lo:hi]]
            aabbs.append(np.concatenate([t.min(axis=(0, 1)),
                                         t.max(axis=(0, 1))]))
            ranges.append((lo, hi - lo))
            return
        c = cent[order[lo:hi]]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (hi - lo) // 2
        part = np.argpartition(c[:, axis], mid)
        order[lo:hi] = order[lo:hi][part]
        rec(lo, lo + mid)
        rec(lo + mid, hi)

    if n:
        rec(0, n)
    else:
        aabbs.append(np.array([1e9, 1e9, 1e9, -1e9, -1e9, -1e9], np.float32))
        ranges.append((0, 0))
    return (order.astype(np.int32),
            np.asarray(aabbs, np.float32),
            np.asarray(ranges, np.int32))


def build_clusters(tris9: np.ndarray, leaf_size: int = 16):
    """C++ builder when available, numpy fallback otherwise."""
    try:
        from ..runtime.native import build_clusters_native

        out = build_clusters_native(tris9, leaf_size)
        if out is not None:
            return out
    except Exception:
        pass
    return build_clusters_py(tris9, leaf_size)
