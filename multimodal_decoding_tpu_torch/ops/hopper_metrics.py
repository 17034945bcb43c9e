"""Streamed pairwise-accuracy scorers on Hopper: hand-written count-GEMM kernels.

Counterpart of ``multimodal_decoding_tpu/ops/pallas_metrics.py``, with its
public names and argument layouts.  Each function returns the pairwise 2-AFC
accuracy ``[B]`` of a per-vertex similarity ``sim [B, nv, nv]``, counting
``sim_ij < sim_ii`` over ``j < nv`` and dividing by ``nv^2 - nv``, without
ever writing ``sim`` to device memory:

* ``streamed_pairwise_acc(preds [B, nv, D], latents [nv, D])``:
  ``sim = preds (latents / |latents|)^T`` (the latent rows are normalised
  here; prediction row norms cancel in the per-row comparisons).
* ``streamed_acc_from_factors(Xv_b [B, nv, K], Z [B, K, nv])``: ``sim = Xv_b Z``.
* ``streamed_acc_from_inv(Xv_b [B, nv, K], inv [B, K, K], U [B, K, nv])``:
  ``sim = Xv_b (inv U)``, where ``inv U`` is formed by the hand-written GEMM
  of the same source, not by a library call.

On a CUDA tensor each launches the kernels of ``csrc/streamed_count.cu``
(built with ``nvcc`` at first use, loaded with ``ctypes`` by
``ops/_cuda_build``); they read their operands through strides, so a
transposed view costs no copy.  The kernels copy an operand 16 bytes at a
time where its rows are 16-byte aligned, else 8 or 4 bytes, so the port
allocates the ``[B, K, nv]`` operands U and Z with ``padded_empty``.  On a
CPU tensor each runs its ``*_plain`` version: a dense ``sim`` by
``torch.matmul``, then ``M.pairwise_acc_from_sim``.  There is no fallback
from one to the other.

Precision: each function takes the JAX function's ``precision``
(``ops/precision.py``: ``"highest"``, ``"high"`` or ``"default"``) and runs
the kernel variant of that name: float32 FMAs at highest, bf16 tensor-core
products (one pass, or three at high) with float32 accumulators otherwise.
The first operand (``preds`` or ``Xv_b``) may be bf16, as the selection path
hands it over under ``cv_dtype``; its values are exact.  Either way
the diagonal is taken from the kernel's own diagonal tile, so it is the
arithmetic of the entries it is compared with.  The plain versions compute
``sim`` with ``ops/precision.matmul`` at the same precision.

``launches`` counts each function's kernel calls on the card (one per call,
whatever the variant; the CPU path does not count), ``launches_by_precision``
the same per precision; ``reset_launches`` sets both to 0.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_decoding_tpu_torch.ops import _cuda_build
from multimodal_decoding_tpu_torch.ops import metrics as M
from multimodal_decoding_tpu_torch.ops import precision as PR

_SOURCE = "streamed_count.cu"
_STRIDED_GEMM = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                 ctypes.c_int]
_SIGNATURES = {
    # ..., batch, nv, kd, precision, a_bf16, counts, stream
    "streamed_count_launch": _STRIDED_GEMM + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    # ..., batch, m, n, kd, precision, c, ldc, stream
    "gemm_store_launch": _STRIDED_GEMM + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
}
# the source's `precision` argument
_PRECISION_CODE = {"highest": 0, "default": 1, "high": 2}

KERNELS = ("streamed_pairwise_acc", "streamed_acc_from_inv", "streamed_acc_from_factors")
launches = dict.fromkeys(KERNELS, 0)
launches_by_precision = {name: dict.fromkeys(PR.PRECISIONS, 0) for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
        launches_by_precision[name] = dict.fromkeys(PR.PRECISIONS, 0)


def padded_empty(batch: int, rows: int, cols: int, device) -> torch.Tensor:
    """An uninitialised float32 ``[batch, rows, cols]`` view whose rows start
    16 bytes apart (a multiple of 4 floats), so the kernels copy it 16 bytes
    at a time; ``torch.matmul(..., out=view)`` fills it."""
    ld = -(-cols // 4) * 4
    return torch.empty((batch, rows, ld), dtype=torch.float32, device=device)[..., :cols]


def _unit_rows(latents: torch.Tensor) -> torch.Tensor:
    return latents / torch.linalg.vector_norm(latents, dim=-1, keepdim=True)


def _uses_kernel(name: str, first: torch.Tensor, *others: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors the kernel
    takes (a float32 or bf16 first operand, float32 others); raises otherwise."""
    devices = {t.device for t in (first, *others)}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes a float32 or bf16 first operand; got {first.dtype}")
    for t in others:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32; got {t.dtype}")
    return True


def _check_shapes(name: str, expected: str, ok: bool, *tensors: torch.Tensor) -> None:
    if not ok:
        got = ", ".join(str(tuple(t.shape)) for t in tensors)
        raise ValueError(f"{name} expects {expected}; got {got}")


def _call(fn_name: str, *args) -> None:
    lib = _cuda_build.load(_SOURCE, _SIGNATURES)
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {rc}")


def _count_on_card(name: str, a: torch.Tensor, bm: torch.Tensor, bm_strides, b: int,
                   nv: int, kd: int, precision: str) -> torch.Tensor:
    """Accuracies [b] of sim = A Bm by the count kernel at ``precision``,
    counted as a launch of ``name``.

    A [b, nv, kd] is float32 or bf16 (read k-contiguous: a bf16 A whose k
    stride is not 1 is copied so); ``bm_strides`` = (batch, k, column)
    strides of the float32 Bm [b, kd, nv], in elements.
    """
    a_bf16 = a.dtype == torch.bfloat16
    if a_bf16 and a.stride(-1) != 1:
        a = a.contiguous()
    counts = torch.zeros((b,), dtype=torch.int32, device=a.device)
    if b and nv and kd:
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            _call("streamed_count_launch", a.data_ptr(), *a.stride(), bm.data_ptr(),
                  *bm_strides, b, nv, kd, _PRECISION_CODE[precision], int(a_bf16),
                  counts.data_ptr(), stream)
        launches[name] += 1
        launches_by_precision[name][precision] += 1
    return M.count_ratio(counts, nv * nv - nv)


def inv_times_u_on_card(inv: torch.Tensor, U: torch.Tensor,
                        precision: str = "highest") -> torch.Tensor:
    """Z = inv [B, K, K] @ U [B, K, nv] by the source's GEMM kernel at
    ``precision``, into a ``padded_empty`` view (the Z GEMM of
    ``streamed_acc_from_inv``; not counted as a launch on its own)."""
    b, k, nv = U.shape
    Z = padded_empty(b, k, nv, U.device)
    if b and nv and k:
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            _call("gemm_store_launch", inv.data_ptr(), *inv.stride(), U.data_ptr(),
                  *U.stride(), b, k, nv, k, _PRECISION_CODE[PR.resolve(precision)],
                  Z.data_ptr(), Z.stride(1), stream)
    return Z


# ---------------------------------------------------------------------------
# Plain versions (the CPU path; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def streamed_pairwise_acc_plain(preds: torch.Tensor, latents: torch.Tensor,
                                precision="highest") -> torch.Tensor:
    return M.pairwise_acc_from_sim(PR.matmul(preds, _unit_rows(latents).mT, precision))


def streamed_acc_from_inv_plain(Xv_b: torch.Tensor, inv: torch.Tensor, U: torch.Tensor,
                                precision="highest") -> torch.Tensor:
    return M.pairwise_acc_from_sim(PR.matmul(Xv_b, PR.matmul(inv, U, precision), precision))


def streamed_acc_from_factors_plain(Xv_b: torch.Tensor, Z: torch.Tensor,
                                    precision="highest") -> torch.Tensor:
    return M.pairwise_acc_from_sim(PR.matmul(Xv_b, Z, precision))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def streamed_pairwise_acc(preds: torch.Tensor, latents: torch.Tensor,
                          precision="highest") -> torch.Tensor:
    """Pairwise accuracy [B] of preds [B, nv, D] against latents [nv, D].

    Equals ``pairwise_acc_from_dist(cosine_distances(preds, latents))``
    without the distance matrix.
    """
    name = "streamed_pairwise_acc"
    precision = PR.resolve(precision)
    _check_shapes(name, "preds [B, nv, D] and latents [nv, D]",
                  preds.dim() == 3 and latents.dim() == 2
                  and tuple(preds.shape[1:]) == tuple(latents.shape), preds, latents)
    if not _uses_kernel(name, preds, latents):
        return streamed_pairwise_acc_plain(preds, latents, precision)
    b, nv, d = preds.shape
    # Bm[b, k, j] = y[j, k], shared by every vertex (batch stride 0), stored
    # [D, nv] with padded rows (a copy of nv x D floats, once per call): the
    # kernel reads it as it reads Z
    y_t = padded_empty(1, d, nv, preds.device)[0].copy_(_unit_rows(latents).mT)
    return _count_on_card(name, preds, y_t, (0, y_t.stride(0), 1), b, nv, d, precision)


def streamed_acc_from_factors(Xv_b: torch.Tensor, Z: torch.Tensor,
                              precision="highest") -> torch.Tensor:
    """Pairwise accuracy [B] of sim = Xv_b [B, nv, K] @ Z [B, K, nv]."""
    name = "streamed_acc_from_factors"
    precision = PR.resolve(precision)
    _check_shapes(name, "Xv_b [B, nv, K] and Z [B, K, nv]",
                  Xv_b.dim() == 3 and Z.dim() == 3 and Z.shape[0] == Xv_b.shape[0]
                  and Z.shape[1] == Xv_b.shape[2] and Z.shape[2] == Xv_b.shape[1], Xv_b, Z)
    if not _uses_kernel(name, Xv_b, Z):
        return streamed_acc_from_factors_plain(Xv_b, Z, precision)
    b, nv, k = Xv_b.shape
    return _count_on_card(name, Xv_b, Z, Z.stride(), b, nv, k, precision)


def streamed_acc_from_inv(Xv_b: torch.Tensor, inv: torch.Tensor, U: torch.Tensor,
                          precision="highest") -> torch.Tensor:
    """Pairwise accuracy [B] of sim = Xv_b [B, nv, K] @ (inv [B, K, K] @ U [B, K, nv]).

    On the card ``Z = inv U`` is formed by the source's own GEMM kernel into
    a padded workspace and read back by the count kernel (one call), both at
    ``precision``: at ``"default"`` inv and U are rounded for Z, and Z again
    for the count, as the TPU kernel's two dots round them.
    """
    name = "streamed_acc_from_inv"
    precision = PR.resolve(precision)
    _check_shapes(name, "Xv_b [B, nv, K], inv [B, K, K] and U [B, K, nv]",
                  Xv_b.dim() == 3 and inv.dim() == 3 and U.dim() == 3
                  and inv.shape[0] == U.shape[0] == Xv_b.shape[0]
                  and inv.shape[1] == inv.shape[2] == U.shape[1] == Xv_b.shape[2]
                  and U.shape[2] == Xv_b.shape[1], Xv_b, inv, U)
    if not _uses_kernel(name, Xv_b, inv, U):
        return streamed_acc_from_inv_plain(Xv_b, inv, U, precision)
    b, nv, k = Xv_b.shape
    Z = inv_times_u_on_card(inv, U, precision)
    return _count_on_card(name, Xv_b, Z, Z.stride(), b, nv, k, precision)
