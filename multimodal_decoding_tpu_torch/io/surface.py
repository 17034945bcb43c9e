"""Surface meshes: FreeSurfer geometry IO, synthetic icospheres, k-NN adjacency.

Port of ``multimodal_decoding_tpu/io/surface.py``.  The FreeSurfer readers,
``icosphere`` and the mesh edges (``mesh_edges``, ``edge_lengths``,
``edge_lengths_dict``, for TFCE and the cluster tables) are copies.  ``knn_adjacency`` keeps an exact float64 KD-tree as
its default (the adjacency is a build-once cached artifact, so exactness wins
over speed); its ``"device"`` method and ``radius_adjacency`` run blocked
``|q|^2 - 2 q.p + |p|^2`` distances with ``torch.topk`` on the device, where
the JAX package used ``jax.lax.top_k``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from multimodal_decoding_tpu_torch.device import resolve_device

TRIANGLE_MAGIC = 0xFFFFFE


@dataclass
class SurfaceMesh:
    coordinates: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32

    @property
    def n_vertices(self) -> int:
        return len(self.coordinates)


def _read_int3(f) -> int:
    b = f.read(3)
    return (b[0] << 16) | (b[1] << 8) | b[2]


def read_freesurfer_geometry(path: str) -> SurfaceMesh:
    """Parse a FreeSurfer binary triangle-surface file (big-endian)."""
    with open(path, "rb") as f:
        magic = _read_int3(f)
        if magic != TRIANGLE_MAGIC:
            raise ValueError(f"Not a FreeSurfer triangle file (magic={magic:#x}): {path}")
        # "created by" comment: terminated by two newline bytes
        prev = b""
        while True:
            c = f.read(1)
            if c == b"" or (prev == b"\n" and c == b"\n"):
                break
            prev = c
        n_vertices, n_faces = struct.unpack(">ii", f.read(8))
        coords = np.frombuffer(f.read(n_vertices * 12), dtype=">f4").reshape(n_vertices, 3)
        faces = np.frombuffer(f.read(n_faces * 12), dtype=">i4").reshape(n_faces, 3)
    return SurfaceMesh(
        coords.astype(np.float32), faces.astype(np.int32)
    )


def write_freesurfer_geometry(path: str, mesh: SurfaceMesh, comment: str = "mmd_tpu") -> None:
    with open(path, "wb") as f:
        f.write(bytes([(TRIANGLE_MAGIC >> 16) & 0xFF, (TRIANGLE_MAGIC >> 8) & 0xFF, TRIANGLE_MAGIC & 0xFF]))
        f.write(comment.encode() + b"\n\n")
        f.write(struct.pack(">ii", mesh.n_vertices, len(mesh.faces)))
        f.write(mesh.coordinates.astype(">f4").tobytes())
        f.write(mesh.faces.astype(">i4").tobytes())


def icosphere(subdivisions: int = 2, radius: float = 100.0) -> SurfaceMesh:
    """Subdivided icosahedron; same topology family as fsaverage meshes."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    def normalize(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    verts = normalize(verts)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = normalize((verts_list[a] + verts_list[b]) / 2.0)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for f0, f1, f2 in faces:
            m01, m12, m20 = midpoint(f0, f1), midpoint(f1, f2), midpoint(f2, f0)
            new_faces += [[f0, m01, m20], [f1, m12, m01], [f2, m20, m12], [m01, m12, m20]]
        verts = np.array(verts_list)
        faces = np.array(new_faces, dtype=np.int64)

    return SurfaceMesh((verts * radius).astype(np.float32), faces.astype(np.int32))


def mesh_edges(mesh: SurfaceMesh) -> np.ndarray:
    """Unique undirected edges [(min, max)] from faces, sorted.

    Same edge set as the reference's face-based construction
    (cluster_analysis.py:231-245) but deduplicated (the reference keeps
    duplicate dict insertions which collapse to the same keys).
    """
    f = mesh.faces
    e = np.vstack([f[:, [0, 1]], f[:, [0, 2]], f[:, [1, 2]]])
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return e


def edge_lengths(mesh: SurfaceMesh):
    """(edges [E,2], lengths [E]) with Euclidean lengths on the mesh coords."""
    e = mesh_edges(mesh)
    d = np.sqrt(np.sum((mesh.coordinates[e[:, 0]] - mesh.coordinates[e[:, 1]]) ** 2, axis=1))
    return e, d


def edge_lengths_dict(mesh: SurfaceMesh) -> dict:
    """{(v0, v1): length} dict, reference contract (cluster_analysis.py:243)."""
    e, d = edge_lengths(mesh)
    return {(int(a), int(b)): float(l) for (a, b), l in zip(e, d)}


def _sq_dists(queries: torch.Tensor, pts: torch.Tensor, pts_sq: torch.Tensor) -> torch.Tensor:
    q_sq = torch.sum(queries * queries, dim=1)
    return q_sq[:, None] - 2.0 * (queries @ pts.T) + pts_sq[None, :]


def knn_adjacency(coords: np.ndarray, k: int, block: int = 4096, method: str = "exact",
                  device=None):
    """k-NN over mesh coordinates.

    Returns (indices [V, k] int32, distances [V, k] float32), sorted by
    distance with the query point first, like sklearn
    ``NearestNeighbors.kneighbors``.

    method="exact" (default) uses scipy's KD-tree in float64.  The JAX
    package uses sklearn's; the port does not depend on sklearn.  Both are
    exact, so they return the same neighbours and distances, except in the
    order of, and the choice at the k-th place among, points at exactly equal
    distance (a regular icosphere is full of such ties).  So score maps match
    the JAX package's across packages only through the shared adjacency
    cache (``decoding/searchlight.build_adjacency``'s ``cache_dir``).
    method="device" runs the blocked distances + ``torch.topk`` on ``device``
    (float32; boundary neighbours may differ on near-ties).
    """
    if method == "exact":
        from scipy.spatial import cKDTree

        pts = np.asarray(coords, dtype=np.float64)
        dists, idx = cKDTree(pts).query(pts, k=k, workers=-1)
        return (idx.reshape(len(pts), k).astype(np.int32),
                dists.reshape(len(pts), k).astype(np.float32))
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(coords, dtype=np.float32), device=dev)
    pts_sq = torch.sum(pts * pts, dim=1)
    v = len(pts)
    indices = np.empty((v, k), dtype=np.int32)
    dists = np.empty((v, k), dtype=np.float32)
    for start in range(0, v, block):
        d2 = _sq_dists(pts[start:start + block], pts, pts_sq)
        neg_d2, idx = torch.topk(-d2, k, dim=1)
        stop = start + len(d2)
        indices[start:stop] = idx.cpu().numpy()
        dists[start:stop] = torch.sqrt(torch.clamp(-neg_d2, min=0.0)).cpu().numpy()
    return indices, dists


def radius_adjacency(coords: np.ndarray, radius: float, block: int = 4096, device=None):
    """Radius-ball adjacency as a padded/masked fixed-shape tensor.

    Every neighbourhood is padded to the largest count: returns (indices
    [V, Kmax], mask [V, Kmax], n_neighbors [V]).  Padded slots repeat the
    vertex's nearest neighbour (itself) and are masked out of the ridge fit.
    The counts are int32, as the JAX package's (the results pickle's
    ``n_neighbors`` and the shared adjacency cache hold them).
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(coords, dtype=np.float32), device=dev)
    pts_sq = torch.sum(pts * pts, dim=1)
    v = len(pts)
    r2 = float(radius) ** 2
    counts = np.concatenate([
        torch.sum(_sq_dists(pts[s:s + block], pts, pts_sq) <= r2, dim=1,
                  dtype=torch.int32).cpu().numpy()
        for s in range(0, v, block)
    ])
    kmax = int(counts.max())

    indices = np.empty((v, kmax), dtype=np.int32)
    mask = np.empty((v, kmax), dtype=bool)
    for s in range(0, v, block):
        neg, idx = torch.topk(-_sq_dists(pts[s:s + block], pts, pts_sq), kmax, dim=1)
        idx, d2 = idx.cpu().numpy(), (-neg).cpu().numpy()
        m = d2 <= r2
        idx = np.where(m, idx, idx[:, :1])
        indices[s:s + len(idx)] = idx
        mask[s:s + len(idx)] = m
    return indices, mask, counts
