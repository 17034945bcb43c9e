"""Batched SPD inverse on Hopper: the hand-written panel kernel and its driver.

Counterpart of ``multimodal_decoding_tpu/ops/pallas_solvers.py``.

* ``chol_inv_panel`` replaces the Pallas kernel of the same name: for a batch
  ``[B, PB, PB]`` of float32 SPD blocks it returns ``L^-1`` with
  ``L = chol(A)`` lower.  On a CUDA tensor it launches the CUDA kernel in
  ``csrc/chol_inv_panel.cu`` (built with ``nvcc`` at first use and loaded
  with ``ctypes`` by ``ops/_cuda_build``); on a CPU tensor it runs
  ``chol_inv_panel_plain``.  There is no fallback from one to the other.
* ``blocked_cholesky`` is the factor half of both drivers below: a
  right-looking blocked Cholesky whose diagonal panels go through
  ``chol_inv_panel``, each panel's column a GEMM against ``L_pp^-T`` and
  each trailing update a GEMM on the trailing submatrix alone.
* ``blocked_spd_inverse`` is the torch driver around it that forms the
  inverse (port of the Pallas driver, ``PANEL = 64``): blocked forward
  substitution and ``inv = M^T M``.  K is padded to a panel multiple with an
  identity block, which is exactly identity in the inverse.
* ``blocked_cholesky_solve`` solves ``A X = B`` with the same factor: K cut
  into near-equal panels of at most ``MAX_PANEL`` (``cholesky_panels``), no
  padding, then a blocked forward and a blocked back substitution, every
  product a batched float32 GEMM.  It replaces ``torch.cholesky_solve`` on
  the card, which sends a batch to MAGMA, whose triangular solves allocate
  and free their workspace with ``cudaMalloc``/``cudaFree`` on every call,
  outside PyTorch's caching allocator (``cudaFree`` synchronises the device
  with the host).  This solve runs on the current stream, allocates only
  through the caching allocator and never waits for the device.

``launches`` counts the CUDA kernel's launches (the CPU path does not count),
so a run can show that its main path went through the kernel;
``reset_launches`` sets it to 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multimodal_decoding_tpu_torch.ops import _cuda_build
from multimodal_decoding_tpu_torch.ops import precision as PR

PANEL = 64
MAX_PANEL = 192  # the kernel keeps a whole block in shared memory

_SOURCE = "chol_inv_panel.cu"
_SIGNATURES = {"chol_inv_panel_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]}

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def chol_inv_panel_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``L^-1`` of ``chol(a)`` by a triangular solve vs I."""
    L = torch.linalg.cholesky(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def chol_inv_panel(a: torch.Tensor) -> torch.Tensor:
    """``[B, PB, PB]`` float32 SPD blocks -> ``L^-1`` of their lower Cholesky factor.

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    takes contiguous float32 input with ``PB <= 192`` and raises otherwise.
    """
    global launches
    if a.dim() != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"chol_inv_panel expects [B, PB, PB]; got {tuple(a.shape)}")
    if a.device.type == "cpu":
        return chol_inv_panel_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"chol_inv_panel runs on cuda or cpu, not {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"chol_inv_panel kernel takes float32; got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("chol_inv_panel kernel takes a contiguous tensor")
    b, pb = a.shape[0], a.shape[-1]
    if pb > MAX_PANEL:
        raise ValueError(f"chol_inv_panel kernel takes PB <= {MAX_PANEL}; got {pb}")
    out = torch.empty_like(a)
    if b == 0 or pb == 0:
        return out
    lib = _cuda_build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = lib.chol_inv_panel_launch(a.data_ptr(), out.data_ptr(), b, pb, stream)
    if rc != 0:
        raise RuntimeError(f"chol_inv_panel launch failed: cudaError {rc}")
    launches += 1
    return out


def cholesky_panels(k: int) -> list:
    """Edges ``[0, ..., k]`` of the fewest near-equal panels of at most
    ``MAX_PANEL`` that cover ``k``, the larger ones first: 750 -> panels of
    188, 188, 187, 187; 804 -> 161 x 4 and 160."""
    n = -(-k // MAX_PANEL)
    edges = [0]
    for i in range(n):
        edges.append(edges[-1] + k // n + (1 if i < k % n else 0))
    return edges


def blocked_cholesky(A: torch.Tensor, edges, precision="highest") -> tuple:
    """Right-looking blocked Cholesky of float32 SPD blocks ``A [B, K, K]``
    over the panels ``edges[p]:edges[p + 1]``; ``A`` is left as it is.

    Returns ``(F, d_invs)``: ``d_invs[p] = L_pp^-1`` from ``chol_inv_panel``,
    and ``F``'s blocks below the diagonal panels hold ``L``'s
    (``F[:, edges[p + 1]:, edges[p]:edges[p + 1]]`` is ``L[p + 1:, p]``); the
    rest of ``F`` is scratch.  The GEMMs run at ``precision``.
    """
    F = A.to(torch.float32, copy=True)
    k = F.shape[-1]
    d_invs = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        d_inv = chol_inv_panel(F[:, lo:hi, lo:hi].contiguous())
        d_invs.append(d_inv)
        if hi < k:
            # L[p+1:, p] = A[p+1:, p] L_pp^-T, then the trailing submatrix's update
            col = PR.matmul(F[:, hi:, lo:hi], d_inv.mT, precision)
            F[:, hi:, lo:hi] = col
            F[:, hi:, hi:] -= PR.matmul(col, col.mT, precision)
    return F, d_invs


def blocked_spd_inverse(A: torch.Tensor, panel: int = PANEL, precision="highest") -> torch.Tensor:
    """Batched SPD inverse ``[B, K, K] -> A^-1`` (port of the Pallas driver).

    The diagonal panels are factorised and inverted by ``chol_inv_panel``
    (float32 inside, as the TPU kernel); everything else is batched GEMMs at
    ``precision`` (``ops/precision.py``).
    """
    def mm(x, y):
        return PR.matmul(x, y, precision)

    b, k = A.shape[0], A.shape[-1]
    k_pad = ((k + panel - 1) // panel) * panel
    work = A.to(torch.float32)
    if k_pad != k:
        pad = k_pad - k
        work = torch.nn.functional.pad(work, (0, pad, 0, pad))
        idx = torch.arange(k, k_pad, device=A.device)
        work[:, idx, idx] = 1.0
    edges = list(range(0, k_pad + 1, panel))
    F, d_invs = blocked_cholesky(work, edges, precision)

    # blocked forward substitution: row-panel p of L^-1 is
    # M[p] = D_inv_p @ (I_p - L[p, :lo] @ M[:lo])
    M = torch.zeros((b, k_pad, k_pad), dtype=torch.float32, device=A.device)
    eye = torch.eye(k_pad, dtype=torch.float32, device=A.device)
    for (lo, hi), d_inv in zip(zip(edges[:-1], edges[1:]), d_invs):
        rhs = eye[lo:hi][None] - mm(F[:, lo:hi, :lo], M[:, :lo])
        M[:, lo:hi, :] = mm(d_inv, rhs)
    inv = mm(M.mT, M)
    return inv[:, :k, :k]


def blocked_cholesky_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``X = A^-1 B`` for SPD ``A [..., K, K]`` and ``B [..., K, D]`` (batch
    dimensions broadcast), float32 at ``"highest"`` throughout.

    The factor is ``blocked_cholesky`` over ``cholesky_panels(K)``; then
    ``Y_p = L_pp^-1 (B_p - L[p, :p] Y[:p])`` and
    ``X_p = L_pp^-T (Y_p - L[p+1:, p]^T X[p+1:])``, panel by panel, each a
    batched GEMM, X written over Y in one buffer.  A block that is not SPD
    gives NaN (``chol_inv_panel``), where ``torch.linalg.cholesky`` raises.
    """
    k = A.shape[-1]
    # numpy's, not torch.broadcast_shapes: the first call of that imports
    # torch._refs, seconds of a process's set-up
    batch = np.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A3 = A.expand(*batch, k, k).reshape(-1, k, k)
    X = B.to(torch.float32).expand(*batch, *B.shape[-2:]).reshape(-1, *B.shape[-2:]).clone()
    edges = cholesky_panels(k)
    F, d_invs = blocked_cholesky(A3, edges)
    panels = list(zip(edges[:-1], edges[1:]))
    for (lo, hi), d_inv in zip(panels, d_invs):
        rhs = X[:, lo:hi]
        if lo:
            rhs = torch.baddbmm(rhs, F[:, lo:hi, :lo], X[:, :lo], alpha=-1.0)
        X[:, lo:hi] = torch.bmm(d_inv, rhs)
    for (lo, hi), d_inv in zip(reversed(panels), reversed(d_invs)):
        rhs = X[:, lo:hi]
        if hi < k:
            rhs = torch.baddbmm(rhs, F[:, hi:, lo:hi].mT, X[:, hi:], alpha=-1.0)
        X[:, lo:hi] = torch.bmm(d_inv.mT, rhs)
    return X.reshape(*batch, *B.shape[-2:])
