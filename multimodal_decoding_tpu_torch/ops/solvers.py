"""Batched SPD solvers: Cholesky vs the Schur-complement recursion.

Port of ``multimodal_decoding_tpu/ops/solvers.py`` with the same method
names, so configs and tests line up name for name:

* ``"cholesky"``: the strict refit path.  On a CUDA tensor the blocked
  Cholesky solve ``ops/hopper_solvers.blocked_cholesky_solve`` (panels
  through the hand-written panel kernel, GEMM substitutions, nothing that
  allocates outside PyTorch's caching allocator or waits for the device);
  on a CPU tensor ``torch.linalg.cholesky`` + ``torch.cholesky_solve``, as
  the JAX package computes it.
* ``"schur"`` / ``"schur-cb"``: ``schur_spd_inverse`` with LU or
  Cholesky-inverse base blocks, then one GEMM against the right-hand side.
* ``"schur-pallas"``: the Schur recursion with ``base=192`` whose base blocks
  go through the hand-written panel kernel
  (``ops/hopper_solvers.chol_inv_panel``); the recursion's GEMMs stay
  ``torch.matmul``, as the JAX package left them to XLA.
* ``"pallas"``: the blocked driver ``ops/hopper_solvers.blocked_spd_inverse``
  around the same kernel.

* ``"schur-cb16"`` / ``"schur-cb16-ns"``: the recursion on bf16 storage
  after scaling by the mean of the diagonal, Cholesky base blocks in
  float32; ``-ns`` adds one Newton-Schulz step at ``"highest"``.
* ``"tri-inv"``: one Cholesky, the blocked GEMM triangular inverse
  ``tri_lower_inverse`` and ``A^-1 = L^-T L^-1``.

``precision`` (``ops/precision.py``) is the JAX argument of the same name
for the recursion's and the apply's GEMMs; ``apply_dtype`` narrows the
inverse and the right-hand side of the apply GEMM, as in the JAX package.
Defaults are ``"highest"``: float32 throughout, as the port's strict path.
The base block's ``L^-T L^-1`` GEMM stays float32 at every precision (the
JAX package leaves it to XLA's default precision, which is float32 off the
TPU).
"""

from __future__ import annotations

import torch

from multimodal_decoding_tpu_torch.ops import precision as PR
from multimodal_decoding_tpu_torch.ops.hopper_solvers import (
    blocked_cholesky_solve,
    blocked_spd_inverse,
    chol_inv_panel,
)
from multimodal_decoding_tpu_torch.utils.profiling import count

SOLVERS = ("cholesky", "schur", "schur-cb", "schur-cb16", "schur-cb16-ns", "tri-inv",
           "schur-pallas", "pallas")


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


def schur_spd_inverse(A: torch.Tensor, base: int = 128, precision="highest",
                      base_method: str = "lu") -> torch.Tensor:
    """Batched SPD inverse via recursive Schur complements.

    ``A [..., K, K]`` SPD -> ``A^-1``, with only GEMMs above ``base``:
    ``inv([[P, Q], [Q^T, S]])`` from ``P^-1`` (recursive), the Schur
    complement ``T = S - Q^T P^-1 Q``, ``T^-1`` (recursive) and GEMM
    reassembly.  Intermediates keep A's dtype: a bf16 A recurses on bf16
    storage (each product float32, then cast), base blocks factorise in
    float32.
    """
    k = A.shape[-1]
    dt = A.dtype
    wt = torch.float32 if dt == torch.bfloat16 else dt  # where sums are taken

    def mm(a, b):
        return PR.matmul(a, b, precision).to(dt)

    if k <= base:
        return _base_inverse(A.to(wt), base_method).to(dt)
    half = (k + 1) // 2
    P = A[..., :half, :half]
    Q = A[..., :half, half:]
    S = A[..., half:, half:]

    P_inv = schur_spd_inverse(P, base, precision, base_method)
    PiQ = mm(P_inv, Q)
    T = (S.to(wt) - PR.matmul(Q.mT, PiQ, precision)).to(dt)
    T_inv = schur_spd_inverse(T, base, precision, base_method)

    PiQ_Ti = mm(PiQ, T_inv)
    TL = (P_inv.to(wt) + PR.matmul(PiQ_Ti, PiQ.mT, precision)).to(dt)
    TR = -PiQ_Ti
    top = torch.cat([TL, TR], dim=-1)
    bottom = torch.cat([TR.mT, T_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def tri_lower_inverse(L: torch.Tensor, base: int = 128, precision="highest") -> torch.Tensor:
    """Batched lower-triangular inverse by a blocked GEMM recursion.

    ``inv([[L11, 0], [L21, L22]]) = [[L11^-1, 0], [-L22^-1 L21 L11^-1,
    L22^-1]]``: only GEMMs above ``base``, a triangular solve vs I at it.
    """
    k = L.shape[-1]
    if k <= base:
        return torch.linalg.solve_triangular(L, _eye_like(L), upper=False)
    half = (k + 1) // 2
    L11i = tri_lower_inverse(L[..., :half, :half], base, precision)
    L22i = tri_lower_inverse(L[..., half:, half:], base, precision)
    BL = -PR.matmul(PR.matmul(L22i, L[..., half:, :half], precision), L11i, precision)
    zeros = torch.zeros(L.shape[:-2] + (half, k - half), dtype=L.dtype, device=L.device)
    top = torch.cat([L11i, zeros], dim=-1)
    bottom = torch.cat([BL, L22i], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def spd_inverse_via_tri(A: torch.Tensor, base: int = 128, precision="highest") -> torch.Tensor:
    """SPD inverse as one Cholesky, ``tri_lower_inverse`` and ``L^-T L^-1``."""
    L_inv = tri_lower_inverse(torch.linalg.cholesky(A), base, precision)
    return PR.matmul(L_inv.mT, L_inv, precision)


def _schur_cb16_inverse(A: torch.Tensor, precision, newton_schulz: bool) -> torch.Tensor:
    """``"schur-cb16(-ns)"``: the Schur recursion on bf16 storage.

    A is scaled by the mean of its diagonal first, so bf16's 8-bit mantissa
    spans the alpha range without overflow or underflow of the Schur
    complements.  ``newton_schulz``: one step ``X (2I - A X)``, whose two
    GEMMs run at ``"highest"`` (at a narrower precision the correction would
    itself be of bf16 quality).
    """
    scale = torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)[..., None, None]
    A_s = A / scale
    inv = schur_spd_inverse(A_s.to(torch.bfloat16), precision=precision,
                            base_method="cholesky").to(torch.float32)
    if newton_schulz:
        eye2 = 2.0 * torch.eye(A.shape[-1], dtype=torch.float32, device=A.device)
        inv = PR.matmul(inv, eye2 - PR.matmul(A_s, inv, "highest"), "highest")
    return inv / scale


def spd_inverse(A: torch.Tensor, method: str = "schur-pallas",
                precision="highest") -> torch.Tensor:
    """Batched SPD inverse with the same method vocabulary as ``spd_solve``."""
    if method == "cholesky":
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(_eye_like(A), L)
    if method == "schur":
        return schur_spd_inverse(A, precision=precision)
    if method == "schur-cb":
        return schur_spd_inverse(A, precision=precision, base_method="cholesky")
    if method in ("schur-cb16", "schur-cb16-ns"):
        return _schur_cb16_inverse(A, precision, method == "schur-cb16-ns")
    if method == "tri-inv":
        return spd_inverse_via_tri(A, precision=precision)
    if method == "schur-pallas":
        return schur_spd_inverse(A, base=192, precision=precision, base_method="pallas")
    if method == "pallas":
        return blocked_spd_inverse(A, precision=precision)
    raise ValueError(f"unknown SPD inverse method: {method}")


def spd_solve(A: torch.Tensor, B: torch.Tensor, method: str = "cholesky",
              precision="highest", apply_dtype=None) -> torch.Tensor:
    """Solve ``A X = B`` for batched SPD ``A``.

    "cholesky" factorises and solves in float32 (``precision`` and
    ``apply_dtype`` do not apply): on a CUDA tensor by
    ``blocked_cholesky_solve``, each such solve counted as
    ``mdt.solve.blocked``.  Every other method forms the inverse
    (``spd_inverse``) and applies it with one GEMM at ``precision``.  ``apply_dtype`` (selection
    grade) casts the inverse and ``B`` to a narrow dtype for that GEMM, with
    float32 output; the ``"schur-cb16*"`` methods apply in float32.
    """
    if method == "cholesky":
        if A.device.type == "cuda":
            count("mdt.solve.blocked", 1)
            return blocked_cholesky_solve(A, B)
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(B, L)
    if method not in SOLVERS:
        raise ValueError(f"unknown SPD solver: {method}")
    inv = spd_inverse(A, method, precision)
    if apply_dtype is not None and not method.startswith("schur-cb16"):
        inv, B = inv.to(apply_dtype), B.to(apply_dtype)
    return PR.matmul(inv, B, precision)
