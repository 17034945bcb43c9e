"""Inputs of the benchmark's cells, made from the run's seed.

Bulk data is made on the device in a few large calls with a
``torch.Generator`` seeded from ``--seed``; small host-side draws (null
shuffles, imagery derangements, samples) come from numpy generators seeded
from the same number.  Both the program and the plain reference receive
these inputs; neither makes its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed64(seed: int) -> int:
    """``--seed`` as a non-negative 64-bit integer (any whole number is a seed)."""
    return int(seed) % (1 << 64)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed64(seed))


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of draws of this seed."""
    return np.random.default_rng([seed64(seed), *stream])


# numpy streams of a seed
STREAM_SHUFFLES, STREAM_DERANGEMENTS, STREAM_SAMPLE = 1, 2, 3


# ---------------------------------------------------------------------------
# The mesh and its neighbourhoods
# ---------------------------------------------------------------------------


def icosphere_coords(subdivisions: int, radius: float = 100.0) -> np.ndarray:
    """Vertex coordinates [10 * 4**s + 2, 3] (float32) of a subdivided icosahedron.

    Each level appends the midpoints of the previous level's edges, so the
    first 10 * 4**l + 2 vertices are those of level l, as on FreeSurfer's
    fsaverage meshes (fsaverage7 is the level-7 subdivision, 163,842
    vertices a hemisphere).
    """
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], dtype=np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        n_faces = len(faces)
        edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                        axis=1)
        uniq, inverse = np.unique(edges, axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        m01, m12, m20 = (inverse.reshape(-1) + len(verts)).reshape(3, n_faces)
        verts = np.concatenate([verts, mids])
        f0, f1, f2 = faces.T
        faces = np.concatenate([np.stack(f, axis=1) for f in
                                ((f0, m01, m20), (f1, m12, m01), (f2, m20, m12), (m01, m12, m20))])
    return (verts * radius).astype(np.float32)


def knn_on_device(coords: np.ndarray, k: int, device, block: int = 4096) -> np.ndarray:
    """The ``k`` nearest vertices of every vertex, nearest first: int32 [V, k].

    Blocked squared distances ``|q|^2 - 2 q.p + |p|^2`` in float32 and
    ``topk``, on ``device``.  Which of several equidistant vertices takes the
    k-th place is the device's choice; both sides of every comparison get
    this one adjacency.
    """
    pts = torch.as_tensor(coords, dtype=torch.float32, device=device)
    sq = (pts * pts).sum(dim=1)
    out = torch.empty((len(pts), k), dtype=torch.int32, device=device)
    for s in range(0, len(pts), block):
        q = pts[s:s + block]
        d2 = sq[s:s + block, None] - 2.0 * (q @ pts.T) + sq[None, :]
        out[s:s + len(q)] = torch.topk(d2, k, dim=1, largest=False, sorted=True).indices
        del d2
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# Betas and latents
# ---------------------------------------------------------------------------


def standardize_rows_fit(x: torch.Tensor, n_fit: int) -> torch.Tensor:
    """Scale the columns of ``x`` in place by the mean and standard deviation
    (ddof 0) of its first ``n_fit`` rows, as the study's train-fit scaler does;
    zero-variance columns keep their scale."""
    mean = x[:n_fit].mean(dim=0)
    std = x[:n_fit].std(dim=0, correction=0)
    std = torch.where(std == 0, torch.ones_like(std), std)
    return x.sub_(mean).div_(std)


def planted_searchlight(gen: torch.Generator, coords: np.ndarray, n_train: int, n_test: int,
                        n_imag: int, d: int, signal_log10: tuple, device):
    """One hemisphere's standardised betas ``X_all`` [N_all, V] and latents.

    ``X = noise + Y W`` with each vertex's weights W[:, v] scaled by
    ``10 ** s(v)``, s rising linearly from ``signal_log10[0]`` at the south
    pole to ``signal_log10[1]`` at the north pole: neighbourhoods range from
    no decodable signal to a saturated one, so the CV selection picks alphas
    across the grid.  Returns ``X_all`` (device, float32, rows train | test |
    imagery) and the standardised latents ``(Y_train, Y_test, Y_imag)`` on
    the device.
    """
    n_all = n_train + n_test + n_imag
    z = torch.as_tensor(coords[:, 2] / np.linalg.norm(coords, axis=1), dtype=torch.float32,
                        device=device)
    lo, hi = signal_log10
    scale = 10.0 ** (lo + (hi - lo) * (z + 1.0) / 2.0)
    Y = standardize_rows_fit(torch.randn((n_all, d), generator=gen, device=device), n_train)
    X = torch.randn((n_all, len(coords)), generator=gen, device=device)
    W = torch.randn((d, len(coords)), generator=gen, device=device).mul_(scale)
    X.addmm_(Y, W)
    del W
    standardize_rows_fit(X, n_train)
    return X, (Y[:n_train], Y[n_train:n_train + n_test], Y[n_train + n_test:])


def planted_betas_host(gen: torch.Generator, n_rows: tuple, v: int, d: int, noise: float,
                       block_cols: int, device):
    """Whole-brain betas in host memory, made on the device block by block.

    ``X = Z G / sqrt(d) + noise * E`` over ``v`` features, ``Z`` [N_all, d]
    the stimuli's content, standardised column by column with the train
    rows' statistics and copied into row-major host arrays, one
    ``block_cols``-column block at a time.  Returns ``(hosts, Z)``: the host
    arrays of the row groups ``n_rows`` (train, test, imagery) and ``Z`` on
    the device.
    """
    n_all = sum(n_rows)
    bounds = np.cumsum((0,) + tuple(n_rows))
    Z = torch.randn((n_all, d), generator=gen, device=device)
    hosts = [np.empty((r, v), dtype=np.float32) for r in n_rows]
    staging = torch.empty((n_all, block_cols), dtype=torch.float32,
                          pin_memory=torch.device(device).type == "cuda")
    for lo in range(0, v, block_cols):
        w = min(block_cols, v - lo)
        G = torch.randn((d, w), generator=gen, device=device).div_(math.sqrt(d))
        X = torch.randn((n_all, w), generator=gen, device=device).mul_(noise).addmm_(Z, G)
        standardize_rows_fit(X, n_rows[0])
        part = staging[:, :w]
        part.copy_(X)
        block = part.numpy()
        for host, r0, r1 in zip(hosts, bounds[:-1], bounds[1:]):
            host[:, lo:lo + w] = block[r0:r1]
    return hosts, Z


def latent_set(gen: torch.Generator, Z: torch.Tensor, noise: float,
               n_train: int) -> np.ndarray:
    """One model's latents ``Z + noise * E``, standardised with the train
    rows' statistics: a host float32 array whose rows follow ``Z``'s."""
    Y = torch.randn(Z.shape, generator=gen, device=Z.device).mul_(noise).add_(Z)
    return standardize_rows_fit(Y, n_train).cpu().numpy()


# ---------------------------------------------------------------------------
# Null shuffles and imagery derangements
# ---------------------------------------------------------------------------


def within_modality_shuffles(r: np.random.Generator, n_perms: int, n_test: int) -> np.ndarray:
    """[P, n_test] int32 shuffles of the test rows within each modality half
    (captions, then images), each with no row left in place (the upstream
    study rejects a draw with a fixed point and draws again)."""
    half = n_test // 2
    out = []
    while len(out) < n_perms:
        s = np.concatenate([r.permutation(half), half + r.permutation(n_test - half)])
        if not np.any(s == np.arange(n_test)):
            out.append(s)
    return np.stack(out).astype(np.int32)


def derangement_choices(seed: int, block: int, block_size: int, n_perms: int) -> np.ndarray:
    """[B, P] choices (0 or 1) of one of the two 3-element imagery
    derangements for each (vertex, shuffle) of vertex block ``block``."""
    return rng(seed, STREAM_DERANGEMENTS, block).integers(0, 2, (block_size, n_perms),
                                                           dtype=np.int64)
