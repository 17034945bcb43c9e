"""The port's compile-and-run checks: one block step, and a multi-rank dry run.

Counterpart of the repository's ``__graft_entry__.py``:

* ``entry(device)`` returns ``(fn, args)``: ``fn(*args)`` runs the main
  path's block step (the per-vertex alpha-CV searchlight block, with the
  alpha selection on ``"schur-pallas"`` and the strict Cholesky refit) on
  tiny seeded inputs (``np.random.RandomState(0)``, the JAX file's draw
  order) and returns the block's score maps stacked in the JAX package's
  order (a jitted function returns a dict with its keys sorted), one
  ``[n_metrics, B]`` tensor.  On CUDA the selection's base
  blocks launch the hand-written panel kernel.
* ``dryrun_multichip(n, device)`` runs ``parallel/distributed
  .multichip_training_step`` on a world of n ranks (gloo processes on the
  CPU; on CUDA one process per visible GPU, NCCL) and checks that every
  output is finite.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.device import resolve_device


def entry(device=None):
    """(fn, args) of the searchlight CV block step on tiny seeded inputs."""
    from multimodal_decoding_tpu_torch.decoding.searchlight_engine import (
        TestLayout,
        searchlight_block_cv,
    )

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    n_train, n_test, n_imag, d, v, k, b = 32, 10, 3, 8, 64, 6, 16

    def draw(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=device)

    X_all = draw(n_train + n_test + n_imag, v)
    Y_train, Y_test, Y_imag = draw(n_train, d), draw(n_test, d), draw(n_imag, d)
    idx = torch.as_tensor(
        np.stack([rng.choice(v, size=k, replace=False) for _ in range(b)]).astype(np.int64),
        device=device)
    alphas = torch.as_tensor([1e-1, 1e1, 1e3], dtype=torch.float32, device=device)
    layout = TestLayout.from_stim_types(np.array(["caption"] * 5 + ["image"] * 5))

    def fn(X_all, Y_train, Y_test, Y_imag, idx):
        scores = searchlight_block_cv(X_all, Y_train, Y_test, Y_imag, idx, None, alphas,
                                      layout=layout, n_train=n_train, n_test=n_test,
                                      cv_solver="schur-pallas")
        return torch.stack([scores[m] for m in sorted(scores)])

    return fn, (X_all, Y_train, Y_test, Y_imag, idx)


def _dryrun_rank(device: str):
    """One rank's share of the dry run (module level: spawned ranks import it)."""
    from multimodal_decoding_tpu_torch.parallel.distributed import multichip_training_step
    from multimodal_decoding_tpu_torch.parallel.mesh import feature_mesh, vertex_mesh

    return multichip_training_step(vertex_mesh(device), feature_mesh(device))


def dryrun_multichip(n_devices: int, device=None):
    """One sharded training step on a world of ``n_devices`` ranks.

    On the CPU the ranks are gloo processes; on CUDA there must be at least
    ``n_devices`` visible GPUs (NCCL puts one rank on each).  A world of one
    runs in this process (on the default process group, made if missing);
    larger worlds are started with ``parallel/mesh.spawn_world``.  Returns
    rank 0's (whole-brain predictions, {metric: scores}), after checking
    that every rank's outputs are finite.
    """
    from multimodal_decoding_tpu_torch.parallel.mesh import spawn_world

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"need {n_devices} GPUs, have {torch.cuda.device_count()}")
    if n_devices == 1:
        results = [_dryrun_rank(dev.type)]
    else:
        results = spawn_world(_dryrun_rank, n_devices, args=(dev.type,), device=dev.type)
    for preds_wb, scores in results:
        if not np.all(np.isfinite(preds_wb)):
            raise AssertionError("non-finite whole-brain predictions")
        for m, s in scores.items():
            if not np.all(np.isfinite(s)):
                raise AssertionError(f"non-finite scores: {m}")
    preds_wb, scores = results[0]
    print(f"dryrun_multichip OK on {n_devices} {dev.type} ranks: "
          f"whole-brain preds {preds_wb.shape}, {len(scores)} searchlight score maps")
    return preds_wb, scores
