"""Batched SPD inverse on Hopper: the hand-written panel kernel and its driver.

Counterpart of ``multimodal_decoding_tpu/ops/pallas_solvers.py``.

* ``chol_inv_panel`` replaces the Pallas kernel of the same name: for a batch
  ``[B, PB, PB]`` of float32 SPD blocks it returns ``L^-1`` with
  ``L = chol(A)`` lower.  On a CUDA tensor it launches the CUDA kernel in
  ``csrc/chol_inv_panel.cu`` (built with ``nvcc`` at first use and loaded
  with ``ctypes`` by ``ops/_cuda_build``); on a CPU tensor it runs
  ``chol_inv_panel_plain``.  There is no fallback from one to the other.
* ``blocked_spd_inverse`` is the torch driver around the same kernel: a
  right-looking blocked Cholesky (``PANEL = 64``) whose diagonal panels go
  through ``chol_inv_panel``, with GEMM trailing updates, blocked forward
  substitution and ``inv = M^T M``.  K is padded to a panel multiple with an
  identity block, which is exactly identity in the inverse.

``launches`` counts the CUDA kernel's launches (the CPU path does not count),
so a run can show that its main path went through the kernel;
``reset_launches`` sets it to 0.
"""

from __future__ import annotations

import ctypes

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
    n_panels = k_pad // panel
    r = torch.arange(k_pad, device=A.device)

    # blocked right-looking Cholesky: L column-panels + diagonal-panel inverses
    l_cols, d_invs = [], []
    for p in range(n_panels):
        lo = p * panel
        linv_pp = chol_inv_panel(work[:, lo:lo + panel, lo:lo + panel].contiguous())
        # L[:, lo:, lo:lo+PB] = A_work[:, lo:, lo:lo+PB] @ L_pp^-T, rows >= lo
        l_col = mm(work[:, :, lo:lo + panel], linv_pp.mT)
        l_col = torch.where((r >= lo)[None, :, None], l_col, 0.0)
        # trailing update, only on indices past this panel
        trail = ((r >= lo + panel)[:, None] & (r >= lo + panel)[None, :]).to(work.dtype)
        work = work - mm(l_col, l_col.mT) * trail
        l_cols.append(l_col)
        d_invs.append(linv_pp)
    L = torch.cat(l_cols, dim=-1)

    # blocked forward substitution: row-panel p of L^-1 is
    # M[p] = D_inv_p @ (I_p - L[p, :lo] @ M[:lo])
    M = torch.zeros((b, k_pad, k_pad), dtype=torch.float32, device=A.device)
    eye = torch.eye(k_pad, dtype=torch.float32, device=A.device)
    for p in range(n_panels):
        lo = p * panel
        l_row = torch.where((r < lo)[None, None, :], L[:, lo:lo + panel, :], 0.0)
        rhs = eye[lo:lo + panel][None] - mm(l_row, M)
        M[:, lo:lo + panel, :] = mm(d_invs[p], rhs)
    inv = mm(M.mT, M)
    return inv[:, :k, :k]
