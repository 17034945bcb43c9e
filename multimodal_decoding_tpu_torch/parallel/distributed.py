"""Multi-GPU compute steps over a ``torch.distributed`` world.

Port of ``multimodal_decoding_tpu/parallel/distributed.py``.  Where the JAX
package wraps each step in ``shard_map`` over a device mesh, here every rank
(one process per GPU) runs the step on its own shard and the collectives are
explicit:

* ``sharded_gram``: the whole-brain gram ``K = X X^T`` with the FEATURE axis
  split over the ranks: each rank multiplies its column slab, one all_reduce
  sums the partial grams.
* ``sharded_searchlight_step`` / ``sharded_searchlight_cv_step``: a fused
  searchlight block with the VERTEX axis split over the ranks; betas are
  replicated, each rank computes its rows, one all_gather per score map.
* ``sharded_null_t_maps``: group-null t-maps with the PERMUTATION axis split.

Every function here is a collective: every rank calls it, in the same order.
``multichip_training_step`` composes them on tiny shapes for
``entry.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from multimodal_decoding_tpu_torch.decoding.searchlight_engine import (
    TestLayout,
    searchlight_block,
    searchlight_block_cv,
)
from multimodal_decoding_tpu_torch.device import as_float32
from multimodal_decoding_tpu_torch.ops import precision as PR
from multimodal_decoding_tpu_torch.ops.ridge import (
    cross_matrix,
    dual_ridge_fit,
    dual_ridge_predict,
)
from multimodal_decoding_tpu_torch.parallel.multihost import (
    all_gather_rows,
    host_shard_bounds,
    replicate_host_filled,
    replicate_rows,
    shard_rows_from_host,
)


def sharded_gram(X, mesh) -> torch.Tensor:
    """K = X X^T with the columns of X [n, F] split over the ranks of ``mesh``.

    Every rank passes the whole X (host or device) and multiplies only its
    columns ``host_shard_bounds(F, rank, W)`` (any F); one all_reduce of the
    [n, n] partials gives every rank K.
    """
    lo, hi = host_shard_bounds(X.shape[1], mesh.rank, mesh.size)
    x = as_float32(X[:, lo:hi], mesh.device)
    k = x @ x.mT
    dist.all_reduce(k)
    return k


def _gather_scores(scores: dict, mesh) -> dict:
    return {m: all_gather_rows(v, mesh) for m, v in scores.items()}


def sharded_searchlight_step(mesh, layout: TestLayout, n_train: int, n_test: int,
                             alpha: float = 1.0):
    """A vertex-sharded fixed-alpha searchlight block step.

    Returns fn(X_all [N, V], Y_train, Y_test, Y_imag, idx [B, K]) ->
    {metric: [B]} on every rank: each rank runs its rows of ``idx`` (B a
    multiple of the world size), and the score maps are all-gathered.
    """

    def fn(X_all, Y_train, Y_test, Y_imag, idx):
        scores = searchlight_block(
            as_float32(X_all, mesh.device), as_float32(Y_train, mesh.device),
            as_float32(Y_test, mesh.device), as_float32(Y_imag, mesh.device),
            shard_rows_from_host(idx, mesh).long(), None, alpha,
            layout=layout, n_train=n_train, n_test=n_test)
        return _gather_scores(scores, mesh)

    return fn


def sharded_searchlight_cv_step(mesh, layout: TestLayout, n_train: int, n_test: int,
                                alphas, cv_solver: str | None = None, cv_dtype=None,
                                cv_precision=None):
    """A vertex-sharded alpha-CV searchlight block step.

    ``cv_solver``, ``cv_dtype`` and ``cv_precision`` mean what they mean in
    ``searchlight_block_cv`` (None: the strict settings); the shipped ones
    of a device are ``ops/precision``'s ``default_cv_*`` functions.  The
    refit is the strict Cholesky solve.  Returns fn as
    ``sharded_searchlight_step`` does, with ``best_alpha`` among the maps.
    """
    alphas_d = torch.as_tensor(alphas, dtype=torch.float32, device=mesh.device)

    def fn(X_all, Y_train, Y_test, Y_imag, idx):
        scores = searchlight_block_cv(
            as_float32(X_all, mesh.device), as_float32(Y_train, mesh.device),
            as_float32(Y_test, mesh.device), as_float32(Y_imag, mesh.device),
            shard_rows_from_host(idx, mesh).long(), None, alphas_d,
            layout=layout, n_train=n_train, n_test=n_test, cv_solver=cv_solver,
            cv_precision=cv_precision, cv_dtype=cv_dtype)
        return _gather_scores(scores, mesh)

    return fn


def sharded_null_t_maps(scores, permutations, popmean: float, mesh) -> torch.Tensor:
    """Group-permutation null t-maps with the PERMUTATION axis split.

    Every rank passes the same [S, P_within, V] scores and [P_group, S]
    permutations (P_group a multiple of the world size: pad with repeats and
    slice, as ``ops/stats.null_min_t_sweep`` does); each rank computes its
    slice of the [P_group, V] t-maps and one all_gather replicates them.
    """
    from multimodal_decoding_tpu_torch.ops.stats import null_t_maps

    if len(permutations) % mesh.size:
        raise ValueError(
            f"len(permutations)={len(permutations)} must be divisible by the world "
            f"size {mesh.size}; pad with repeats and slice, or chunk upstream "
            "(ops/stats.null_min_t_sweep pads for you)")
    lo, hi = host_shard_bounds(len(permutations), mesh.rank, mesh.size)
    local = null_t_maps(as_float32(scores, mesh.device), np.asarray(permutations)[lo:hi],
                        popmean)
    return all_gather_rows(local, mesh)


def multichip_training_step(mesh_v, mesh_f):
    """One full 'training step' of the framework across the world.

    Composes the sharding patterns on tiny shapes, drawn from
    ``np.random.RandomState(0)`` in the JAX step's order: (1) the
    feature-sharded whole-brain gram + dual ridge fit + prediction, (2) the
    vertex-sharded searchlight block fed by per-rank row shards, (3) the
    vertex-sharded alpha-CV block at the shipped selection settings, (3b) the
    same block at the TPU's shipped combination, ``"schur-pallas"`` with
    bf16 selection storage at ``"default"`` (the ``cvtpu_*`` maps), (4) the
    permutation-sharded group-null t-maps with per-rank null ingestion.
    Returns (whole-brain predictions, {metric: [v] scores}) as numpy, the
    same on every rank.
    """
    from multimodal_decoding_tpu_torch.ops.stats import group_permutations

    n_dev = mesh_v.size
    rng = np.random.RandomState(0)
    n_train, n_test, n_imag, d = 24, 10, 3, 6
    v = 8 * n_dev  # vertex axis divisible by the world
    f = 16 * n_dev  # feature axis divisible by the world
    k = 5

    X_train = rng.randn(n_train, f).astype(np.float32)
    Y_train = rng.randn(n_train, d).astype(np.float32)
    X_test = rng.randn(n_test, f).astype(np.float32)

    # (1) feature-sharded gram + dual ridge + predict
    K = sharded_gram(X_train, mesh_f)
    dual = dual_ridge_fit(K, Y_train, 10.0, device=mesh_f.device)
    K_q = cross_matrix(X_test, X_train, mesh=mesh_f)
    preds_wb = dual_ridge_predict(K_q, dual, device=mesh_f.device)

    # (2) vertex-sharded searchlight block
    stim_types = np.array(["caption"] * (n_test // 2) + ["image"] * (n_test - n_test // 2))
    layout = TestLayout.from_stim_types(stim_types)
    X_all = rng.randn(n_train + n_test + n_imag, v).astype(np.float32)
    Y_test = rng.randn(n_test, d).astype(np.float32)
    Y_imag = rng.randn(n_imag, d).astype(np.float32)
    idx = np.stack([rng.choice(v, size=k, replace=False) for _ in range(v)]).astype(np.int32)

    # input pipeline: each rank contributes its rows, one all_gather
    # replicates them (parallel/multihost.py), not a host broadcast
    n_rows = n_train + n_test + n_imag
    pad_rows = (-n_rows) % n_dev
    X_padded = np.concatenate(
        [X_all, np.zeros((pad_rows, v), np.float32)]) if pad_rows else X_all
    lo, hi = host_shard_bounds(len(X_padded), mesh_v.rank, n_dev)
    X_all_rep = replicate_rows(X_padded[lo:hi], lo, len(X_padded), mesh_v)[:n_rows]

    step = sharded_searchlight_step(mesh_v, layout, n_train, n_test, alpha=1.0)
    scores = step(X_all_rep, Y_train, Y_test, Y_imag, idx)

    # (3) vertex-sharded alpha-CV block at the shipped selection settings
    dev = mesh_v.device
    shipped = dict(cv_solver=PR.default_cv_solver(dev), cv_dtype=PR.default_cv_dtype(dev),
                   cv_precision=PR.default_cv_precision(dev))
    print("multichip CV step shipped config: "
          + ", ".join(f"{k}={v}" for k, v in shipped.items()))
    cv_step = sharded_searchlight_cv_step(mesh_v, layout, n_train, n_test,
                                          alphas=[1e-1, 1e1, 1e3], **shipped)
    cv_scores = cv_step(X_all_rep, Y_train, Y_test, Y_imag, idx)
    scores = dict(scores, **{f"cv_{m}": s for m, s in cv_scores.items()})

    # (3b) the TPU's shipped combination explicitly: schur-pallas with bf16
    # selection storage at one bf16 pass, so a dry run certifies it on any
    # device (on the CPU the panel kernel's plain version runs)
    cv_step_tpu_cfg = sharded_searchlight_cv_step(
        mesh_v, layout, n_train, n_test, alphas=[1e-1, 1e1, 1e3],
        cv_solver="schur-pallas", cv_dtype=torch.bfloat16, cv_precision="default")
    cv_scores_tpu_cfg = cv_step_tpu_cfg(X_all_rep, Y_train, Y_test, Y_imag, idx)
    scores = dict(scores, **{f"cvtpu_{m}": s for m, s in cv_scores_tpu_cfg.items()})

    # (4) permutation-sharded group-null t-maps with per-rank null ingestion
    n_subj, p_within = 4, 6
    subj_null = rng.rand(n_subj, p_within, v).astype(np.float32)
    lo, hi = host_shard_bounds(n_subj, mesh_v.rank, n_dev)
    fill = np.zeros_like(subj_null)
    fill[lo:hi] = subj_null[lo:hi]
    null_scores = replicate_host_filled(fill, mesh_v)
    perms = group_permutations(p_within, n_subj, 2 * n_dev)
    null_t = sharded_null_t_maps(null_scores, perms, 0.5, mesh_v)
    scores["perm_null_t"] = null_t.amax(dim=1)

    return preds_wb.cpu().numpy(), {m: s.cpu().numpy() for m, s in scores.items()}
