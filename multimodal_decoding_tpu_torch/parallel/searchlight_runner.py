"""Vertex-sharded searchlight runner: vertex blocks -> score maps.

Port of ``multimodal_decoding_tpu/parallel/searchlight_runner.py``: the
padded adjacency is cut into blocks of B vertices, each block runs one block
step of ``decoding/searchlight_engine`` on the device, and the per-block
score vectors come back to host numpy every few blocks.

With a ``"v"`` mesh (``parallel/mesh.vertex_mesh``: one process per GPU),
each block is split over the ranks: rank r runs rows ``host_shard_bounds(B,
r, W)`` of the block through the same engine call, and every block's
outputs are all-gathered on every rank, block by block in the same order.
Only rank 0 writes the checkpoint.

Imagery derangements: block ``b``'s ``[B, P]`` choices are the JAX runner's
``jax.random.randint(fold_in(PRNGKey(null_seed), b), (B, P), 0, 2)``,
computed in numpy (``utils/threefry.py``) for the whole block before a rank
takes its rows, so the nulls do not depend on the world size and both
packages write the same null scores for the same ``null_seed``.
``imagery_derangements`` (one row per padded vertex) overrides the draw.

Between two flushes the host never waits for the card to drain.  On CUDA a
block's indices, mask and derangements go up through a ring of pinned host
buffers with non-blocking copies (``_StagedUploads``: one
``mdt.runner.staged_upload`` a block), the next block's while this one
runs; the score's index constants are built once a call
(``score_constants``); and a flush brings the pending blocks' maps back in
one copy (``_materialize_pending``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from multimodal_decoding_tpu_torch.decoding.searchlight_engine import (
    N_NULL_METRICS,
    TestLayout,
    score_constants,
    searchlight_block,
    searchlight_block_cv,
    searchlight_block_cv_with_null,
    searchlight_block_with_null,
)
from multimodal_decoding_tpu_torch.device import resolve_device, synchronize
from multimodal_decoding_tpu_torch.parallel.mesh import barrier, is_writer, pad_to_multiple
from multimodal_decoding_tpu_torch.parallel.multihost import host_numpy, host_shard_bounds
from multimodal_decoding_tpu_torch.utils import threefry
from multimodal_decoding_tpu_torch.utils.profiling import count, span


def _auto_block_size(n_rows: int, k: int, n_devices: int = 1,
                     budget_bytes: int = 2 << 30) -> int:
    """Pick a vertex block size so the gathered patch tensor fits the budget,
    rounded down to a multiple of the world size (at least one row a rank)."""
    b = max(1, budget_bytes // (n_rows * k * 4))
    b = max(n_devices, (b // n_devices) * n_devices)
    return int(min(b, 4096))


# Device memory allowed for not-yet-copied block outputs (null mode emits
# {metric: [B, P]} per block).
_FLUSH_BUDGET_BYTES = 256 << 20


def _flush_cadence(block_size: int, n_perms: int | None,
                   budget_bytes: int = _FLUSH_BUDGET_BYTES) -> int:
    """How many blocks' outputs may stay on the device before a copy to host.

    Main-mode outputs are ~KB per block, so the cadence only keeps the host
    from waiting on the device after every block (8).  Null-mode outputs are
    ``block_size * n_perms * 4`` bytes per metric per block; the cadence
    keeps pending outputs under ``budget_bytes``.
    """
    if not n_perms:
        return 8
    per_block = block_size * n_perms * 4 * N_NULL_METRICS
    return max(1, min(8, budget_bytes // max(per_block, 1)))


def _materialize_pending(lists: list[list], n_hosted: int, mesh=None) -> int:
    """Copy every not-yet-hosted block dict in each list to host numpy.

    ``lists`` are parallel per-block result lists (main, null); entries at
    index >= n_hosted are device dicts of this rank's rows.  Returns the new
    hosted count.  Without a mesh every pending map comes back in one copy
    (``_host_in_one_copy``).  With a mesh each map is an all_gather of the
    block's rows, so every rank must reach these calls in the same order.
    """
    n = max((len(lst) for lst in lists), default=0)
    pending = [(lst, i) for lst in lists for i in range(min(n_hosted, len(lst)), len(lst))]
    if mesh is not None:
        for lst, i in pending:
            lst[i] = {k: host_numpy(v, mesh) for k, v in lst[i].items()}
        return n
    hosted = iter(_host_in_one_copy([v for lst, i in pending for v in lst[i].values()
                                     if isinstance(v, torch.Tensor)]))
    for lst, i in pending:
        lst[i] = {k: next(hosted) if isinstance(v, torch.Tensor) else v
                  for k, v in lst[i].items()}
    return n


def _host_in_one_copy(tensors: list) -> list:
    """Tensors of one device -> numpy arrays of the same bits, through one
    device-to-host copy: their bytes laid end to end in one device buffer,
    cut apart again on the host."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[at:at + nbytes].view(dtype).reshape(t.shape))
        at += nbytes
    return out


class _StagedUploads:
    """A block's host arrays -> tensors on ``device``, the same dtypes.

    On CUDA the arrays are copied into one slot of a ring of ``SLOTS``
    pinned host buffers, allocated at the first block (``cudaHostAlloc``
    waits for the device, so never inside the loop), and sent with
    non-blocking copies on the current stream; an event recorded behind
    them guards the slot, which the host refills only once that event has
    passed.  The host so runs at most ``SLOTS`` blocks ahead of the card and
    never waits for it to drain.  Each block so sent counts one
    ``mdt.runner.staged_upload``.  On the CPU the arrays become tensors as
    they are.
    """

    SLOTS = 3

    def __init__(self, device: torch.device):
        self.device = device
        self.ring = None  # per slot: (pinned buffers, the event behind their copies)
        self.sent = 0

    def __call__(self, arrays: list) -> list:
        if self.device.type != "cuda":
            return [torch.as_tensor(a) for a in arrays]
        if self.ring is None:
            self.ring = [([torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                                       pin_memory=True) for a in arrays], torch.cuda.Event())
                         for _ in range(self.SLOTS)]
        bufs, done = self.ring[self.sent % self.SLOTS]
        done.synchronize()  # the slot's last copies have left it
        for buf, a in zip(bufs, arrays, strict=True):
            np.copyto(buf.numpy(), a)
        out = [buf.to(self.device, non_blocking=True) for buf in bufs]
        done.record(torch.cuda.current_stream(self.device))
        self.sent += 1
        count("mdt.runner.staged_upload", 1)
        return out


def draw_imagery_derangements(null_seed: int, block: int, block_size: int,
                              n_perms: int) -> np.ndarray:
    """Block ``block``'s [B, P] imagery-derangement choices (0 or 1): the JAX
    runner's ``jax.random.randint(fold_in(PRNGKey(null_seed), block), (B, P),
    0, 2, int32)``, bit for bit."""
    key = threefry.fold_in(threefry.prng_key(null_seed), block)
    return threefry.randint(key, (block_size, n_perms), 0, 2)


def run_searchlight(
    X_train: np.ndarray | None,
    X_test: np.ndarray | None,
    X_imag: np.ndarray | None,
    Y_train: np.ndarray,
    Y_test: np.ndarray,
    Y_imag: np.ndarray,
    adjacency: np.ndarray,
    stim_types_test,
    alpha: float | None = 1.0,
    alphas_cv=None,
    adjacency_mask: np.ndarray | None = None,
    shuffles: np.ndarray | None = None,
    null_seed: int = 0,
    imagery_derangements: np.ndarray | None = None,
    block_size: int | None = None,
    mesh=None,
    device=None,
    dtype=torch.float32,
    precision="highest",
    cv_precision=None,
    cv_solver: str | None = None,
    cv_scorer: str = "xla",
    cv_dtype=None,
    null_gather: str | None = None,
    progress: bool = True,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 64,
    resume: bool = True,
    x_all_device: torch.Tensor | None = None,
    n_rows_split: tuple | None = None,
):
    """Run the full searchlight on one device, or on every rank of ``mesh``.

    Returns ``(scores, aux)``: ``scores`` is {metric: [V] float32}; ``aux``
    carries ``elapsed_s``, ``vertices_per_sec`` (timed on the host after the
    device finished), ``block_size``, ``n_blocks``, and optionally
    ``null_scores`` {metric: [V, P]}, per-vertex ``best_alpha`` (CV mode) and
    ``resumed_at_block``.  With a mesh every rank returns the whole result.

    X_* are the standardised betas (NaN columns dropped), ``adjacency`` the
    [V, K] neighbour-index matrix, ``shuffles`` the [P, n_test] null
    permutations.  ``device`` defaults to ``cuda`` and raises without a GPU;
    with a mesh the device is the rank's (``mesh.device``).

    ``x_all_device`` + ``n_rows_split=(n_train, n_test, n_imag)``: the caller
    already placed the standardised [n_rows, V'] matrix on the device
    (``parallel/ingest.py``); X_train/X_test/X_imag may then be None and no
    host concatenation happens.

    ``dtype``: the storage of the device ``X_all`` built here
    (``torch.bfloat16`` under fast math; a given ``x_all_device`` keeps its
    own).  ``precision``, ``cv_precision``, ``cv_solver``, ``cv_scorer`` and
    ``cv_dtype`` pass through to the engine's block steps, as does
    ``null_gather`` (None: ``"gather"``).
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    n_ranks = mesh.size if mesh is not None else 1
    layout = TestLayout.from_stim_types(stim_types_test)
    if x_all_device is not None:
        if n_rows_split is None:
            raise ValueError("x_all_device requires n_rows_split=(n_train, n_test, n_imag)")
        n_train, n_test, n_imag = n_rows_split
        n_rows = n_train + n_test + n_imag
        if x_all_device.shape[0] != n_rows:
            raise ValueError(f"x_all_device has {x_all_device.shape[0]} rows, "
                             f"n_rows_split sums to {n_rows}")
        X_all_d = x_all_device.to(device)
    else:
        n_train, n_test = len(X_train), len(X_test)
        X_all = np.concatenate([X_train, X_test, X_imag]).astype(np.float32)
        n_rows = X_all.shape[0]
        X_all_d = torch.as_tensor(X_all, device=device).to(dtype)  # cast on the device
        del X_all
    v_total, k = adjacency.shape

    if block_size is None:
        block_size = _auto_block_size(n_rows, k, n_ranks)
    if block_size % n_ranks:
        raise ValueError(f"block_size {block_size} must be a multiple of the "
                         f"{n_ranks}-rank world")
    # this rank's rows of every block
    rows = (slice(*host_shard_bounds(block_size, mesh.rank, n_ranks)) if mesh is not None
            else slice(None))

    idx_padded, v_orig = pad_to_multiple(np.asarray(adjacency, dtype=np.int32), block_size)
    mask_padded = None
    if adjacency_mask is not None:
        mask_padded, _ = pad_to_multiple(np.asarray(adjacency_mask), block_size)

    def to_dev(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    Y_train_d = to_dev(Y_train, torch.float32)
    Y_test_d = to_dev(Y_test, torch.float32)
    Y_imag_d = to_dev(Y_imag, torch.float32)
    alphas_d = to_dev(alphas_cv, torch.float32) if alphas_cv is not None else None

    use_null = shuffles is not None
    use_cv = alphas_cv is not None
    n_blocks = len(idx_padded) // block_size
    n_perms = len(shuffles) if use_null else None
    if use_null:
        shuffles_d = to_dev(shuffles, torch.int64)
        if imagery_derangements is not None and (
                imagery_derangements.shape != (n_blocks * block_size, n_perms)):
            raise ValueError(
                f"imagery_derangements must be [{n_blocks * block_size}, {n_perms}] "
                f"(padded vertices x shuffles); got {imagery_derangements.shape}")

    results: list[dict] = []
    null_results: list[dict] = []
    flush_every = _flush_cadence(block_size, n_perms)
    n_hosted = 0  # results[:n_hosted] (and null_results[:n_hosted]) are host numpy

    # block-granular checkpointing: a killed run loses at most
    # ``checkpoint_every`` blocks.  Every rank sees the same file: the barrier
    # orders the check after any earlier run's writes, the second one keeps
    # rank 0 from removing a stale checkpoint before every rank has looked.
    ckpt_done = -1
    if checkpoint_path is not None:
        barrier(mesh)
        found = os.path.isfile(checkpoint_path)
        if found and resume:
            ck = np.load(checkpoint_path, allow_pickle=True)
            ckpt_done = int(ck["done_blocks"])
            results = list(ck["results"])
            null_results = list(ck["null_results"])
            n_hosted = len(results)
            print(f"resuming searchlight from block {ckpt_done + 1}/{n_blocks}")
        barrier(mesh)
        if found and not resume and is_writer(mesh):
            # overwrite semantics: start from scratch; resuming a stale
            # checkpoint would also inflate vertices_per_sec
            os.remove(checkpoint_path)

    def _save_ckpt(done):
        nonlocal n_hosted
        if checkpoint_path is None:
            return
        with span("mdt.runner.flush"):
            n_hosted = _materialize_pending([results, null_results], n_hosted, mesh)
            if not is_writer(mesh):
                return
            os.makedirs(os.path.dirname(checkpoint_path) or ".", exist_ok=True)
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(
                tmp.removesuffix(".npz"),
                done_blocks=done,
                results=np.array(results, dtype=object),
                null_results=np.array(null_results, dtype=object),
            )
            os.replace(tmp, checkpoint_path)

    # the step is looked up here, by its name in this module, so a step
    # wrapped under that name before the call runs every block
    step = {(False, False): searchlight_block, (False, True): searchlight_block_with_null,
            (True, False): searchlight_block_cv,
            (True, True): searchlight_block_cv_with_null}[use_cv, use_null]
    step_kw = dict(layout=layout, n_train=n_train, n_test=n_test, precision=precision)
    if use_cv:
        step_kw.update(cv_precision=cv_precision, cv_solver=cv_solver, cv_scorer=cv_scorer,
                       cv_dtype=cv_dtype)
    if use_null:
        step_kw["null_gather"] = "gather" if null_gather is None else null_gather
    # the score's index constants, once a call
    step_kw["constants"] = score_constants(layout, device, shuffles_d if use_null else None)
    uploads = _StagedUploads(device)

    def upload(b):
        """Block ``b``'s rows of the indices, mask and derangements on the
        device, the casts made there."""
        with span("mdt.runner.upload"):
            sl = slice(b * block_size, (b + 1) * block_size)
            arrays = [idx_padded[sl][rows]]
            if mask_padded is not None:
                arrays.append(mask_padded[sl][rows])
            if use_null:
                der = (imagery_derangements[sl] if imagery_derangements is not None
                       else draw_imagery_derangements(null_seed, b, block_size, n_perms))
                arrays.append(der[rows])
            sent = uploads(arrays)
            return (sent[0].to(torch.int64),
                    sent[1].to(torch.bool) if mask_padded is not None else None,
                    sent[-1].to(torch.int64) if use_null else None)

    t0 = time.perf_counter()
    staged = None
    for b in range(ckpt_done + 1, n_blocks):
        with span("mdt.runner.block"):
            idx_b, mask_b, der_d = staged if staged is not None else upload(b)
            out = step(X_all_d, Y_train_d, Y_test_d, Y_imag_d, idx_b, mask_b,
                       alphas_d if use_cv else alpha,
                       *((shuffles_d, der_d) if use_null else ()), **step_kw)
            # the next block's inputs (its derangements drawn here) go up
            # while this one runs on the card
            staged = upload(b + 1) if b + 1 < n_blocks else None
            if use_null:
                results.append(out[0])
                null_results.append(out[1])
            else:
                results.append(out)
            # the last block hosts every output still on the device
            if (b + 1) % flush_every == 0 or b == n_blocks - 1:
                with span("mdt.runner.flush"):
                    n_hosted = _materialize_pending([results, null_results], n_hosted, mesh)
            if checkpoint_every and (b + 1) % checkpoint_every == 0:
                _save_ckpt(b)
            if progress and (b % 10 == 0 or b == n_blocks - 1):
                print(f"searchlight block {b + 1}/{n_blocks}", flush=True)

    synchronize(device)

    def collect(blocks):
        return {m: np.concatenate([blk[m] for blk in blocks])[:v_orig]
                for m in blocks[0].keys()}

    scores = collect(results)
    elapsed = time.perf_counter() - t0
    # rate over the vertices THIS call computed: a resumed run must not
    # claim the checkpointed blocks' work
    done_before = min((ckpt_done + 1) * block_size, v_orig)
    aux = {
        "elapsed_s": elapsed,
        "vertices_per_sec": (v_orig - done_before) / elapsed,
        "block_size": block_size,
        "n_blocks": n_blocks,
    }
    if ckpt_done >= 0:
        aux["resumed_at_block"] = ckpt_done + 1
    if use_null:
        aux["null_scores"] = collect(null_results)
    if use_cv:
        aux["best_alpha"] = scores.pop("best_alpha")
    if checkpoint_path is not None and is_writer(mesh) and os.path.isfile(checkpoint_path):
        os.remove(checkpoint_path)
    return scores, aux
