"""Batched SPD solvers: Cholesky vs the Schur-complement recursion.

Port of ``multimodal_decoding_tpu/ops/solvers.py`` with the same method
names, so configs and tests line up name for name:

* ``"cholesky"``: ``torch.linalg.cholesky`` + ``torch.cholesky_solve``
  (the strict refit path).
* ``"schur"`` / ``"schur-cb"``: ``schur_spd_inverse`` with LU or
  Cholesky-inverse base blocks, then one GEMM against the right-hand side.
* ``"schur-pallas"``: the Schur recursion with ``base=192`` whose base blocks
  go through the hand-written panel kernel
  (``ops/hopper_solvers.chol_inv_panel``); the recursion's GEMMs stay
  ``torch.matmul``, as the JAX package left them to XLA.
* ``"pallas"``: the blocked driver ``ops/hopper_solvers.blocked_spd_inverse``
  around the same kernel.

Everything runs in float32.  The JAX package's bf16-storage variants
(``"schur-cb16"``, ``"schur-cb16-ns"``) and ``"tri-inv"`` are not ported
yet (ROADMAP A15) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from multimodal_decoding_tpu_torch.ops.hopper_solvers import (
    blocked_spd_inverse,
    chol_inv_panel,
)

_NOT_PORTED = ("schur-cb16", "schur-cb16-ns", "tri-inv")


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)


def _base_inverse(A: torch.Tensor, method: str) -> torch.Tensor:
    """Inverse of the recursion's base block.

    "lu": ``torch.linalg.inv``.  "cholesky": ``L^-1`` by a triangular solve
    vs I, then ``A^-1 = L^-T L^-1``.  "pallas": ``L^-1`` from the panel
    kernel, then the same GEMM.
    """
    if method == "lu":
        return torch.linalg.inv(A)
    if method == "cholesky":
        L = torch.linalg.cholesky(A)
        L_inv = torch.linalg.solve_triangular(L, _eye_like(A), upper=False)
        return L_inv.mT @ L_inv
    if method == "pallas":
        L_inv = chol_inv_panel(A.to(torch.float32).contiguous())
        return L_inv.mT @ L_inv
    raise ValueError(f"unknown base inverse method: {method}")


def schur_spd_inverse(A: torch.Tensor, base: int = 128,
                      base_method: str = "lu") -> torch.Tensor:
    """Batched SPD inverse via recursive Schur complements.

    ``A [..., K, K]`` SPD -> ``A^-1``, with only GEMMs above ``base``:
    ``inv([[P, Q], [Q^T, S]])`` from ``P^-1`` (recursive), the Schur
    complement ``T = S - Q^T P^-1 Q``, ``T^-1`` (recursive) and GEMM
    reassembly.
    """
    k = A.shape[-1]
    if k <= base:
        return _base_inverse(A, base_method)
    half = (k + 1) // 2
    P = A[..., :half, :half]
    Q = A[..., :half, half:]
    S = A[..., half:, half:]

    P_inv = schur_spd_inverse(P, base, base_method)
    PiQ = P_inv @ Q
    T = S - Q.mT @ PiQ
    T_inv = schur_spd_inverse(T, base, base_method)

    PiQ_Ti = PiQ @ T_inv
    TL = P_inv + PiQ_Ti @ PiQ.mT
    TR = -PiQ_Ti
    top = torch.cat([TL, TR], dim=-1)
    bottom = torch.cat([TR.mT, T_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _check_method(method: str) -> None:
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"SPD method {method!r} is not ported yet (ROADMAP A15)")


def spd_inverse(A: torch.Tensor, method: str = "schur-pallas") -> torch.Tensor:
    """Batched SPD inverse with the same method vocabulary as ``spd_solve``."""
    _check_method(method)
    if method == "cholesky":
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(_eye_like(A), L)
    if method == "schur":
        return schur_spd_inverse(A)
    if method == "schur-cb":
        return schur_spd_inverse(A, base_method="cholesky")
    if method == "schur-pallas":
        return schur_spd_inverse(A, base=192, base_method="pallas")
    if method == "pallas":
        return blocked_spd_inverse(A)
    raise ValueError(f"unknown SPD inverse method: {method}")


def spd_solve(A: torch.Tensor, B: torch.Tensor, method: str = "cholesky") -> torch.Tensor:
    """Solve ``A X = B`` for batched SPD ``A``.

    "cholesky" factorises and solves; every other method forms the inverse
    (``spd_inverse``) and applies it with one GEMM.
    """
    _check_method(method)
    if method == "cholesky":
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(B, L)
    if method in ("schur", "schur-cb", "schur-pallas", "pallas"):
        return spd_inverse(A, method) @ B
    raise ValueError(f"unknown SPD solver: {method}")
