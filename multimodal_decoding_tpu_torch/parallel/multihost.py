"""Per-rank input shards -> replicated device tensors, over ``torch.distributed``.

Port of ``multimodal_decoding_tpu/parallel/multihost.py``.  Each rank reads
only its slice of the beta files (one stimulus per file) and one all_gather
makes the replicated ``[N, V]`` matrix the searchlight runner consumes, so no
rank reads more than N / world_size files:

    paths = get_fmri_data_paths(...)                       # metadata only
    lo, hi = host_shard_bounds(len(paths), rank, world_size)
    local = load_beta_rows(paths[lo:hi])                   # this rank's I/O
    X = replicate_rows(local, lo, n, mesh)                 # all_gather

Every function that takes a ``mesh`` (``parallel/mesh.Mesh``) is a
collective unless its docstring says otherwise: every rank calls it, in the
same order.  The JAX package's single-process emulation of hosts at device
granularity has no counterpart: the CPU tests run real gloo processes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from multimodal_decoding_tpu_torch.io.gifti import read_gifti


def host_shard_bounds(n_rows: int, host_idx: int, n_hosts: int) -> tuple:
    """Contiguous balanced [lo, hi) row range of one rank (JAX name kept).

    The first ``n_rows % n_hosts`` ranks take one extra row, so every row is
    owned exactly once for any (n_rows, n_hosts).
    """
    if not 0 <= host_idx < n_hosts:
        raise ValueError(f"host_idx {host_idx} out of range for {n_hosts} hosts")
    base, extra = divmod(n_rows, n_hosts)
    lo = host_idx * base + min(host_idx, extra)
    return lo, lo + base + (1 if host_idx < extra else 0)


def load_beta_rows(paths) -> np.ndarray:
    """Read a shard of surface beta files -> [len(paths), V] float32 (the first
    darray of each GIfTI, as the full loader reads it)."""
    return np.array([read_gifti(p).darrays[0].data for p in paths], dtype=np.float32)


def replicate_rows(local_rows, row_start: int, n_total: int, mesh) -> torch.Tensor:
    """Every rank's rows -> the replicated [n_total, ...] tensor: one all_gather.

    The JAX package's ``global_from_host_shards`` + ``replicate_rows`` in one
    call.  Rank r passes rows ``host_shard_bounds(n_total, r, W)``, so
    ``n_total`` must be a multiple of the world size (pad first:
    ``mesh.pad_to_multiple``).
    """
    w = mesh.size
    if n_total % w:
        raise ValueError(f"n_total={n_total} must be divisible by the {w}-rank world; "
                         "pad the stimulus axis first (pad_to_multiple)")
    expected = host_shard_bounds(n_total, mesh.rank, w)
    if (row_start, row_start + len(local_rows)) != expected:
        raise ValueError(f"rank {mesh.rank} passed rows [{row_start}, "
                         f"{row_start + len(local_rows)}), expected {expected}")
    return all_gather_rows(torch.as_tensor(np.asarray(local_rows), device=mesh.device), mesh)


def all_gather_rows(local: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's equally shaped ``local`` along axis 0, by rank."""
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def replicated_from_host(arr, mesh) -> torch.Tensor:
    """A host array that every rank holds -> a tensor on this rank's device.
    No communication (not a collective)."""
    return torch.as_tensor(np.asarray(arr), device=mesh.device)


def shard_rows_from_host(arr, mesh) -> torch.Tensor:
    """A host array that every rank holds -> this rank's rows, on its device.
    Not a collective; the rows are ``host_shard_bounds`` of the array."""
    arr = np.asarray(arr)
    lo, hi = host_shard_bounds(len(arr), mesh.rank, mesh.size)
    return torch.as_tensor(arr[lo:hi], device=mesh.device)


def host_numpy(x, mesh=None) -> np.ndarray:
    """A rank's row shard -> all ranks' rows as host numpy, on every rank.

    With ``mesh``, one all_gather along axis 0 (every rank passes a shard of
    the same shape); without, a plain copy to the host.
    """
    if isinstance(x, np.ndarray):
        return x
    if mesh is not None:
        x = all_gather_rows(x, mesh)
    return x.cpu().numpy()


def replicate_host_filled(fill, mesh) -> torch.Tensor:
    """Union of disjointly filled per-rank arrays: one all_reduce(SUM).

    For artifacts whose shard axis does not divide the world (the [S, P, V]
    null stacks of S subjects): each rank passes an array holding the rows it
    owns and exact zeros elsewhere.  Each entry is owned by one rank, so the
    sum is that rank's value exactly, NaN included.
    """
    out = torch.as_tensor(np.asarray(fill, dtype=np.float32), device=mesh.device).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def distributed_beta_matrix(paths, mesh, pad_value: float = 0.0):
    """Per-rank load + one all_gather -> (X [n_padded, V] on every rank, n).

    Rows are padded to a multiple of the world size with ``pad_value``;
    callers drop the padded rows by the returned count.  Each rank reads only
    its ``host_shard_bounds`` slice of ``paths``.
    """
    n, w = len(paths), mesh.size
    n_padded = -(-n // w) * w
    bounds = [host_shard_bounds(n_padded, r, w) for r in range(w)]
    # every rank finds the same starved ranks, so all raise before the collective
    starved = [r for r, (lo, hi) in enumerate(bounds) if min(hi, n) <= lo]
    if starved:
        raise ValueError(
            f"ranks {starved} own only padding rows ({n} real of {n_padded}): more "
            "ranks than beta files; use fewer ranks or a larger file set")
    lo, hi = bounds[mesh.rank]
    rows = load_beta_rows(paths[lo:min(hi, n)])
    n_pad_here = (hi - lo) - len(rows)
    if n_pad_here:
        rows = np.concatenate(
            [rows, np.full((n_pad_here,) + rows.shape[1:], pad_value, rows.dtype)])
    return replicate_rows(rows, lo, n_padded, mesh), n
