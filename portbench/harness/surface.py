"""Surface meshes of the group-statistics cells, made by the benchmark.

``icosphere`` subdivides the icosahedron as ``data.icosphere_coords`` does
(the same vertices in the same order) and keeps what that function drops:
the faces, and the edge of the level below that each vertex of the last
level halves, by which a field made on the level below is carried up to
the last.  ``hemispheres`` makes the two hemispheres of a deployment from
one such sphere: the left is the sphere, the right its mirror image
(x -> -x) numbered in reverse, so that neither's edge list fits the other.
"""

from __future__ import annotations

import math

import numpy as np


def icosphere(subdivisions: int, radius: float = 100.0):
    """``(coords [V, 3] float32, faces [F, 3] int64, parents [V - V', 2] int64)``:
    ``parents[i]`` is the edge of the level below (V' vertices) whose
    midpoint is vertex V' + i (empty at level 0)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], dtype=np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    parents = np.zeros((0, 2), dtype=np.int64)
    for _ in range(subdivisions):
        n_faces = len(faces)
        edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                        axis=1)
        parents, inverse = np.unique(edges, axis=0, return_inverse=True)
        mids = verts[parents[:, 0]] + verts[parents[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        m01, m12, m20 = (inverse.reshape(-1) + len(verts)).reshape(3, n_faces)
        verts = np.concatenate([verts, mids])
        f0, f1, f2 = faces.T
        faces = np.concatenate([np.stack(f, axis=1) for f in
                                ((f0, m01, m20), (f1, m12, m01), (f2, m20, m12), (m01, m12, m20))])
    return (verts * radius).astype(np.float32), faces, parents


def edges_of(faces: np.ndarray, n_vertices: int) -> np.ndarray:
    """The mesh's undirected edges, each once as (low, high), in increasing
    order: int64 [E, 2]."""
    pairs = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    keys = np.unique(pairs[:, 0] * n_vertices + pairs[:, 1])
    return np.stack([keys // n_vertices, keys % n_vertices], axis=1)


def lengths_of(coords: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Euclidean length of each edge, float64 [E]."""
    c = coords.astype(np.float64)
    return np.linalg.norm(c[edges[:, 0]] - c[edges[:, 1]], axis=1)


def neighbour_table(edges: np.ndarray, n_vertices: int) -> np.ndarray:
    """int64 [V, 1 + max degree]: each vertex, then its neighbours in
    increasing order, a row padded with the vertex itself where it has fewer
    neighbours than the most any vertex has."""
    both = np.concatenate([edges, edges[:, ::-1]])
    both = both[np.lexsort((both[:, 1], both[:, 0]))]
    degree = np.bincount(both[:, 0], minlength=n_vertices)
    width = 1 + int(degree.max())
    table = np.repeat(np.arange(n_vertices, dtype=np.int64)[:, None], width, axis=1)
    slot = np.arange(len(both)) - np.repeat(np.cumsum(degree) - degree, degree)
    table[both[:, 0], 1 + slot] = both[:, 1]
    return table


def hemispheres(subdivisions: int, radius: float = 100.0) -> dict:
    """Both hemispheres of one sphere: {"left" | "right": {"coords", "edges",
    "lengths"}}, plus "parents" (``icosphere``'s) in the left's numbering.
    Vertex v of the left is vertex V - 1 - v of the right."""
    coords, faces, parents = icosphere(subdivisions, radius)
    v = len(coords)
    left = edges_of(faces, v)
    right = edges_of(v - 1 - faces, v)
    mirrored = (coords * np.array([-1.0, 1.0, 1.0], dtype=np.float32))[::-1].copy()
    return {"left": {"coords": coords, "edges": left, "lengths": lengths_of(coords, left)},
            "right": {"coords": mirrored, "edges": right, "lengths": lengths_of(mirrored, right)},
            "parents": parents}
