"""TFCE & cluster analysis over surface meshes.

Copy of ``multimodal_decoding_tpu/ops/tfce.py`` (the port imports nothing of
the JAX package).  Two backends:

* numpy/scipy: vectorised per-threshold connected components
  (scipy.sparse.csgraph), exact reference semantics.  Used for tests and
  observed maps when asked for (``backend="numpy"``).
* native C++ (``native/tfce.cpp``, a copy of the JAX package's, via ctypes):
  single-pass descending-threshold union-find with deferred membership
  resolution, O(E alpha + V + T*C) per map instead of O(T*E), threads over
  maps.  The default.  It is built at first use by ``ops/_host_build``; a
  failed build raises with the compiler's output.  Unlike the JAX package
  there is no silent fallback to numpy: at 10,000 permutations that would
  turn minutes into hours.

Reference semantics preserved exactly:
- edges join a cluster when BOTH endpoint scores are >= threshold
  (cluster_analysis.py:22-24);
- a cluster's node set is only nodes incident to a filtered edge;
- isolated vertices with score > threshold (strict!) get the singleton
  contribution, num_vertices mode only (cluster_analysis.py:300-310);
- thresholds are np.arange(step, max+step, step) (:278), dh==0 -> max/100;
- NaN/inf/<=0 max score -> all-zero map (:256-266).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from multimodal_decoding_tpu_torch.ops import _host_build

_SOURCE = "tfce.cpp"
_native = None
_native_lock = threading.Lock()


def _load_native():
    """The native TFCE library, built at first use (raises if the build fails)."""
    global _native
    with _native_lock:
        if _native is None:
            lib = ctypes.CDLL(_host_build.build(_SOURCE))
            lib.tfce_batch.restype = ctypes.c_int
            lib.tfce_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # values [n_maps, V]
                ctypes.c_int,  # n_maps
                ctypes.c_int,  # V
                ctypes.POINTER(ctypes.c_int),  # edges [E, 2]
                ctypes.POINTER(ctypes.c_float),  # edge lengths [E] (may be null)
                ctypes.c_int,  # E
                ctypes.c_double,  # h
                ctypes.c_double,  # e
                ctypes.c_double,  # dh (0 => auto)
                ctypes.c_int,  # extent mode: 0=num_vertices, 1=edge_lengths
                ctypes.POINTER(ctypes.c_float),  # out [n_maps, V]
                ctypes.c_int,  # n_threads
            ]
            _native = lib
    return _native


# ---------------------------------------------------------------------------
# Clusters (reference calc_clusters parity, cluster_analysis.py:15-75)
# ---------------------------------------------------------------------------


def _filtered_components(scores, threshold, edges):
    """Connected components of edges whose both endpoints score >= threshold.

    Returns (labels [V] with -1 for nodes not in any cluster, n_components).
    NaN scores compare False, excluding those vertices — numpy parity.
    """
    scores = np.asarray(scores)
    v = len(scores)
    with np.errstate(invalid="ignore"):
        ok = (scores[edges[:, 0]] >= threshold) & (scores[edges[:, 1]] >= threshold)
    act = edges[ok]
    if len(act) == 0:
        return np.full(v, -1, dtype=np.int64), 0, ok
    graph = coo_matrix(
        (np.ones(len(act), dtype=np.int8), (act[:, 0], act[:, 1])), shape=(v, v)
    )
    _, raw_labels = connected_components(graph, directed=False)
    in_cluster = np.zeros(v, dtype=bool)
    in_cluster[act[:, 0]] = True
    in_cluster[act[:, 1]] = True
    labels = np.where(in_cluster, raw_labels, -1)
    # compact label ids to 0..n-1 over in-cluster nodes
    uniq, compact = np.unique(labels[in_cluster], return_inverse=True)
    labels[in_cluster] = compact
    return labels, len(uniq), ok


def calc_clusters(
    scores,
    threshold,
    edges,
    edge_lengths=None,
    return_clusters=True,
    return_cluster_edge_lengths=False,
    return_agg_t_values=False,
    return_cluster_map=False,
) -> dict:
    """Cluster dict with the reference's output vocabulary.

    ``edges`` [E, 2] int array + optional ``edge_lengths`` [E] replace the
    reference's {(v0, v1): length} dict (same information, array form).
    """
    scores = np.asarray(scores)
    labels, n, ok = _filtered_components(scores, threshold, np.asarray(edges))
    result = {}
    if return_clusters:
        result["clusters"] = [set(np.where(labels == i)[0].tolist()) for i in range(n)]
    if return_cluster_map:
        cluster_map = np.zeros_like(scores)
        if n:
            sums = np.bincount(
                labels[labels >= 0], weights=scores[labels >= 0], minlength=n
            )
            cluster_map[labels >= 0] = sums[labels[labels >= 0]]
        result["cluster_map"] = cluster_map
    if return_agg_t_values:
        sums = (
            np.bincount(labels[labels >= 0], weights=scores[labels >= 0], minlength=n)
            if n
            else np.zeros(0)
        )
        result["agg_t_values"] = list(sums)
    if return_cluster_edge_lengths:
        if edge_lengths is None:
            raise ValueError("edge_lengths required for cluster_edge_lengths")
        el = np.asarray(edge_lengths)[ok]
        act = np.asarray(edges)[ok]
        sums = (
            np.bincount(labels[act[:, 0]], weights=el, minlength=n) if n else np.zeros(0)
        )
        result["cluster_edge_lengths"] = list(sums)
    return result


# ---------------------------------------------------------------------------
# TFCE
# ---------------------------------------------------------------------------


def _tfce_thresholds(max_score: float, dh) -> tuple[np.ndarray, float]:
    if dh == 0:
        dh = "auto"
    step = max_score / 100 if dh == "auto" else dh
    return np.arange(step, max_score + step, step), step


def tfce_map_numpy(
    values: np.ndarray,
    edges: np.ndarray,
    edge_lengths_arr: np.ndarray | None = None,
    h: float = 2.0,
    e: float = 1.0,
    dh=0.1,
    cluster_extents_measure: str = "num_vertices",
) -> np.ndarray:
    """TFCE for one score map, scipy-backed (reference calc_tfce_values parity)."""
    values = np.asarray(values)
    out = np.zeros(values.shape, dtype=np.float32)
    if values.size == 0 or np.all(np.isnan(values)):
        return out
    max_score = np.nanmax(values)
    if np.isnan(max_score) or np.isinf(max_score) or max_score <= 0:
        return out

    threshs, step = _tfce_thresholds(float(max_score), dh)
    edges = np.asarray(edges)
    for th in threshs:
        labels, n, ok = _filtered_components(values, th, edges)
        in_cluster = labels >= 0
        if n:
            if cluster_extents_measure == "num_vertices":
                extents = np.bincount(labels[in_cluster], minlength=n).astype(np.float64)
            elif cluster_extents_measure == "edge_lengths":
                act = edges[ok]
                el = np.asarray(edge_lengths_arr)[ok]
                extents = np.bincount(labels[act[:, 0]], weights=el, minlength=n)
            else:
                raise RuntimeError("Unknown cluster extents measure: " + cluster_extents_measure)
            contrib = (extents**e) * (th**h) * step
            out[in_cluster] += contrib[labels[in_cluster]].astype(np.float32)
        if cluster_extents_measure == "num_vertices":
            with np.errstate(invalid="ignore"):
                singles = (values > th) & ~in_cluster
            out[singles] += np.float32((1.0**e) * (th**h) * step)
    return out


def tfce_map_native(
    values: np.ndarray,
    edges: np.ndarray,
    edge_lengths_arr: np.ndarray | None = None,
    h: float = 2.0,
    e: float = 1.0,
    dh=0.1,
    cluster_extents_measure: str = "num_vertices",
    n_threads: int | None = None,
) -> np.ndarray:
    """Batched native TFCE; ``values`` may be [V] or [n_maps, V].

    ``n_threads``: host threads fanning out over the MAPS axis (each map's
    dendrogram pass is sequential; maps are independent).  ``None`` reads
    the ``MMD_TFCE_THREADS`` env var; unset/0 means all hardware threads
    (std::thread::hardware_concurrency).  The 10k-permutation null sweep is
    the production consumer (PERF.md gives its ms a map and thread count on
    the GPU machine's host).
    """
    if n_threads is None:
        n_threads = int(os.environ.get("MMD_TFCE_THREADS", "0") or 0)
    lib = _load_native()
    vals = np.ascontiguousarray(np.atleast_2d(np.asarray(values, dtype=np.float32)))
    n_maps, v = vals.shape
    edges_c = np.ascontiguousarray(np.asarray(edges, dtype=np.int32))
    el = (
        np.ascontiguousarray(np.asarray(edge_lengths_arr, dtype=np.float32))
        if edge_lengths_arr is not None
        else None
    )
    out = np.zeros_like(vals)
    mode = 0 if cluster_extents_measure == "num_vertices" else 1
    if mode == 1 and el is None:
        raise ValueError("edge_lengths required for edge_lengths extents")
    rc = lib.tfce_batch(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_maps,
        v,
        edges_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        el.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if el is not None else None,
        len(edges_c),
        float(h),
        float(e),
        0.0 if dh in (0, "auto") else float(dh),
        mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"native tfce_batch failed with code {rc}")
    return out.reshape(np.asarray(values, dtype=np.float32).shape)


def tfce_map(values, edges, edge_lengths_arr=None, h=2.0, e=1.0, dh=0.1,
             cluster_extents_measure="num_vertices", backend="auto",
             n_threads=None):
    """Dispatch: ``"auto"``/``"native"`` run the native engine (a failed build
    raises), ``"numpy"`` the scipy-backed one.

    ``n_threads`` (native backend only): None -> MMD_TFCE_THREADS env var,
    unset/0 -> all hardware threads.  See tfce_map_native.
    """
    if backend == "numpy":
        vals = np.atleast_2d(np.asarray(values))
        out = np.stack(
            [
                tfce_map_numpy(v, edges, edge_lengths_arr, h, e, dh, cluster_extents_measure)
                for v in vals
            ]
        )
        return out.reshape(np.asarray(values).shape)
    if backend not in ("auto", "native"):
        raise ValueError(f"unknown TFCE backend {backend!r} (auto, native, numpy)")
    return tfce_map_native(
        values, edges, edge_lengths_arr, h, e, dh, cluster_extents_measure, n_threads
    )


def calc_tfce_values(
    t_values: dict,
    edges_by_hemi: dict,
    metric: str,
    h: float = 2.0,
    e: float = 1.0,
    dh=0.1,
    edge_lengths_by_hemi: dict | None = None,
    cluster_extents_measure: str = "num_vertices",
    backend: str = "auto",
    hemis=("left", "right"),
) -> dict:
    """Reference-shaped API: {hemi: {metric: [V]}} in, same shape out
    (cluster_analysis.py:248-312)."""
    out = {}
    for hemi in hemis:
        vals = np.asarray(t_values[hemi][metric])
        el = edge_lengths_by_hemi[hemi] if edge_lengths_by_hemi else None
        out[hemi] = {
            metric: tfce_map(
                vals, edges_by_hemi[hemi], el, h, e, dh, cluster_extents_measure, backend
            )
        }
    return out
