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
  At ``"default"`` / ``"high"`` Z may also come as its bf16 planes ``[P, B,
  K, nv]`` (``factor_planes``, the form the selection path hands over),
  read as they are.
* ``streamed_acc_from_inv(Xv_b [B, nv, K], inv [B, K, K], U [B, K, nv])``:
  ``sim = Xv_b (inv U)``, where ``inv U`` is formed by the hand-written GEMM
  of the same source, not by a library call.

On a CUDA tensor each launches the kernels of ``csrc/streamed_count.cu``
(built with ``nvcc`` at first use, loaded with ``ctypes`` by
``ops/_cuda_build``).  On a CPU tensor each runs its ``*_plain`` version: a
dense ``sim`` by ``torch.matmul``, then ``M.pairwise_acc_from_sim``.  There
is no fallback from one to the other.

Precision: each function takes the JAX function's ``precision``
(``ops/precision.py``: ``"highest"``, ``"high"`` or ``"default"``).

* ``"highest"``: the SIMT core, float32 FMAs (a bf16 first operand is
  widened exactly).  It reads its operands through strides, so a transposed
  view costs no copy, 16 bytes at a time where the rows are 16-byte aligned
  (else 8 or 4), so the port allocates the ``[B, K, nv]`` operands U and Z
  with ``padded_empty``.
* ``"default"`` / ``"high"``: the tensor-core core (``wgmma`` on bf16
  shared-memory stages).  Its operands are bf16 planes (``bf16_planes``:
  ``hi = bf16(x)`` and, at high, ``lo = bf16(x - hi)``, each rounded once)
  in rows padded to 64 elements (``padded_planes``): the latents, inv, U, a
  float32 first operand and a float32 Z are rounded once a call by the
  source's ``split_bf16`` kernel, and the Z GEMM (``factor_planes``, inside
  ``streamed_acc_from_inv`` and ahead of ``streamed_acc_from_factors`` on
  the selection path) writes Z straight into planes.  A bf16 first operand
  (``preds`` or ``Xv_b`` as the selection path hands it over under
  ``cv_dtype``) is read as it is where ``tma_eligible`` holds, else from a
  ``padded_copy``; every operand is loaded by tensor map (TMA).  Products:
  hi.hi at default; hi.hi + hi.lo + lo.hi at
  high (hi.hi + hi.lo where the first operand is bf16), float32 sums.

Either way the diagonal is taken from the kernel's own diagonal tile, so it
is the arithmetic of the entries it is compared with.  The plain versions
compute ``sim`` with ``ops/precision.matmul`` at the same precision;
``count_from_planes_plain`` is the tensor-core core's function on planes.

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
# a plane operand: pointer, vertex, row and plane strides, planes
_PLANES_ARG = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int]
_SIGNATURES = {
    # ..., batch, nv, kd, a_bf16, counts, stream
    "streamed_count_launch": _STRIDED_GEMM + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    # ..., batch, m, n, kd, c, ldc, stream
    "gemm_store_launch": _STRIDED_GEMM + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    # A planes, Bm planes, b_shared, batch, nv, kd, counts, stream
    "tc_count_launch": _PLANES_ARG * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    # A planes, Bm planes, batch, m, n, kd, c, c_sb, c_sr, c_plane, stream
    "tc_store_launch": _PLANES_ARG * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] + [
        ctypes.c_longlong] * 3 + [ctypes.c_void_p],
    # x, sb, sr, sc, batch, rows, cols, out, o_sb, o_sr, o_plane, planes, stream
    "split_bf16_launch": [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p],
}
# bf16 planes per operand at each tensor-core precision (hi; hi and lo)
PLANES = {"default": 1, "high": 2}

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


def padded_planes(planes: int, batch: int, rows: int, cols: int, device) -> torch.Tensor:
    """An uninitialised bf16 ``[planes, batch, rows, cols]`` view whose rows
    start 128 bytes apart (a multiple of 64 elements): the layout in which the
    tensor-core kernels read their planes by tensor map, a stage's 64-column
    blocks whole and each 128-byte box row one aligned line, and the Z GEMM
    writes Z."""
    ld = -(-cols // 64) * 64
    return torch.empty((planes, batch, rows, ld), dtype=torch.bfloat16, device=device)[..., :cols]


def padded_copy(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype``, in a view whose rows start 128 bytes apart (a
    multiple of 64 elements): a bf16 ``[nv, B, K]`` fold slice laid out so,
    transposed to ``Xv_b [B, nv, K]``, is ``tma_eligible`` and each of its
    128-byte box rows is one aligned line."""
    ld = -(-x.shape[-1] // 64) * 64
    out = torch.empty((*x.shape[:-1], ld), dtype=dtype, device=x.device)[..., :x.shape[-1]]
    return out.copy_(x)


def bf16_planes_plain(x: torch.Tensor, planes: int) -> torch.Tensor:
    """``bf16_planes`` in plain PyTorch (round to nearest even, as
    ``ops/precision.split_bf16`` rounds)."""
    x = x.to(torch.float32)
    out = padded_planes(planes, *x.shape, x.device)
    out[0].copy_(x)
    if planes == 2:
        out[1].copy_(x - out[0].to(torch.float32))
    return out


def bf16_planes(x: torch.Tensor, planes: int) -> torch.Tensor:
    """float32 ``x [B, R, C]`` (any strides) as bf16 planes ``[planes, B, R,
    C]`` in ``padded_planes``: ``hi = bf16(x)`` and, with two planes,
    ``lo = bf16(x - hi)``, each rounded once.  On the card by the source's
    ``split_bf16`` kernel, on the CPU by ``bf16_planes_plain``."""
    if planes not in (1, 2) or x.dim() != 3:
        raise ValueError(f"bf16_planes takes [B, R, C] and 1 or 2 planes; got "
                         f"{tuple(x.shape)}, {planes}")
    if x.device.type == "cpu":
        return bf16_planes_plain(x, planes)
    if x.dtype != torch.float32:
        raise TypeError(f"bf16_planes kernel takes float32; got {x.dtype}")
    out = padded_planes(planes, *x.shape, x.device)
    if x.numel():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _call("split_bf16_launch", x.data_ptr(), *x.stride(), *x.shape, out.data_ptr(),
                  out.stride(1), out.stride(2), out.stride(0), planes, stream)
    return out


def tma_eligible(t: torch.Tensor) -> bool:
    """Whether a tensor map can describe the bf16 operand ``t [..., rows, k]``
    (k contiguous), so the count kernel loads it by TMA: its base is 16-byte
    aligned and every other axis longer than 1 has a stride that is a
    positive multiple of 16 bytes (8 elements), below 2^40 bytes.  Otherwise
    (the fold patches' transposed view: a vertex stride of K x 2 bytes) the
    count reads a ``padded_copy`` of it."""
    if t.dtype != torch.bfloat16 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return False
    if t.data_ptr() % 16:
        return False
    return all(0 < s and s % 8 == 0 and 2 * s < 2 ** 40
               for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def _unit_rows(latents: torch.Tensor) -> torch.Tensor:
    return latents / torch.linalg.vector_norm(latents, dim=-1, keepdim=True)


def _uses_kernel(name: str, first: torch.Tensor, *others: torch.Tensor,
                 others_dtype=torch.float32) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors the kernel
    takes (a float32 or bf16 first operand, ``others_dtype`` others); raises
    otherwise."""
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
        if t.dtype != others_dtype:
            raise TypeError(f"{name} kernel takes {others_dtype}; got {t.dtype}")
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
    """Accuracies [b] of sim = A Bm by the SIMT count kernel (``"highest"``),
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
                  *bm_strides, b, nv, kd, int(a_bf16), counts.data_ptr(), stream)
        launches[name] += 1
        launches_by_precision[name][precision] += 1
    return M.count_ratio(counts, nv * nv - nv)


def _planes_args(t: torch.Tensor) -> tuple:
    """A plane operand ``[P, B, rows, cols]`` as the source takes it."""
    return t.data_ptr(), t.stride(1), t.stride(2), t.stride(0), t.shape[0]


def _count_tc(name: str, a: torch.Tensor, bm: torch.Tensor, b_shared: bool, b: int, nv: int,
              kd: int, precision: str) -> torch.Tensor:
    """Accuracies [b] of sim = A Bm by the tensor-core count kernel at
    ``precision``, counted as a launch of ``name``.

    A [b, nv, kd] float32 (rounded here into planes) or bf16 (read as it
    is where ``tma_eligible``, else from a ``padded_copy``); ``bm``: Bm's bf16 planes
    ``[P, b or 1, kd, nv]`` (one vertex's, shared by all, where
    ``b_shared``).
    """
    if a.dtype == torch.float32:
        a_planes = bf16_planes(a, PLANES[precision])
    else:
        a_planes = (a if tma_eligible(a) else padded_copy(a, torch.bfloat16)).unsqueeze(0)
    counts = torch.zeros((b,), dtype=torch.int32, device=a.device)
    if b and nv and kd:
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            _call("tc_count_launch", *_planes_args(a_planes), *_planes_args(bm), int(b_shared),
                  b, nv, kd, counts.data_ptr(), stream)
        launches[name] += 1
        launches_by_precision[name][precision] += 1
    return M.count_ratio(counts, nv * nv - nv)


def inv_times_u_on_card(inv: torch.Tensor, U: torch.Tensor,
                        precision: str = "highest") -> torch.Tensor:
    """Z = inv [B, K, K] @ U [B, K, nv] by the source's GEMM kernels at
    ``precision`` (the Z GEMM of ``streamed_acc_from_inv``; not counted as a
    launch on its own).

    ``"highest"``: float32 Z in a ``padded_empty`` view, by the SIMT core.
    ``"default"`` / ``"high"``: Z's bf16 planes ``[P, B, K, nv]`` in
    ``padded_planes`` (hi; and lo = bf16(Z - hi) at high), written by the
    tensor-core core from its float32 accumulators of the rounded inv and U.
    """
    precision = PR.resolve(precision)
    b, k, nv = U.shape
    if precision == "highest":
        Z = padded_empty(b, k, nv, U.device)
        if b and nv and k:
            with torch.cuda.device(U.device):
                stream = torch.cuda.current_stream(U.device).cuda_stream
                _call("gemm_store_launch", inv.data_ptr(), *inv.stride(), U.data_ptr(),
                      *U.stride(), b, k, nv, k, Z.data_ptr(), Z.stride(1), stream)
        return Z
    planes = PLANES[precision]
    Z = padded_planes(planes, b, k, nv, U.device)
    if b and nv and k:
        inv_p, u_p = bf16_planes(inv, planes), bf16_planes(U, planes)
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            _call("tc_store_launch", *_planes_args(inv_p), *_planes_args(u_p), b, k, nv, k,
                  Z.data_ptr(), Z.stride(1), Z.stride(2), Z.stride(0), stream)
    return Z


def planes_eligible(t: torch.Tensor) -> bool:
    """Whether the count can load second-operand planes ``t [P, B, K, nv]``
    by tensor map as they are: bf16, nv contiguous, a 16-byte-aligned base,
    rows a multiple of 128 bytes apart (whole 64-column blocks, as
    ``padded_planes`` lays them out) and the other strides multiples of 16
    bytes."""
    if t.dtype != torch.bfloat16 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return False
    if t.data_ptr() % 16 or t.stride(2) % 64 or t.stride(2) < t.shape[-1]:
        return False
    return all(0 < s and s % 8 == 0 and 2 * s < 2 ** 40
               for n, s in zip(t.shape[:2], t.stride()[:2]) if n > 1)


def factor_planes(inv: torch.Tensor, U: torch.Tensor, precision: str) -> torch.Tensor:
    """Z = inv [B, K, K] @ U [B, K, nv] at ``"default"`` or ``"high"``, as
    the bf16 planes ``[P, B, K, nv]`` (``padded_planes``) that
    ``streamed_acc_from_factors`` reads as they are: hi, and lo = bf16(Z -
    hi) at high, Z's float32 sums rounded once to nearest even.

    This is the TPU's ``jnp.matmul(inv, U, precision=DEFAULT|HIGH)``
    followed by the count kernel's rounding of Z.  On the card it is
    ``inv_times_u_on_card``, the hand-written GEMM that
    ``streamed_acc_from_inv`` forms its Z with (not counted as a launch); on
    the CPU ``bf16_planes_plain(PR.matmul(inv, U, precision), P)``.
    """
    name = "factor_planes"
    precision = PR.resolve(precision)
    if precision not in PLANES:
        raise ValueError(f"{name} forms bf16 planes at {tuple(PLANES)}; got {precision!r}")
    _check_shapes(name, "inv [B, K, K] and U [B, K, nv]",
                  inv.dim() == 3 and U.dim() == 3 and inv.shape[0] == U.shape[0]
                  and inv.shape[1] == inv.shape[2] == U.shape[1], inv, U)
    if not _uses_kernel(name, inv, U):
        return bf16_planes_plain(PR.matmul(inv, U, precision), PLANES[precision])
    return inv_times_u_on_card(inv, U, precision)


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
    """Z float32 [B, K, nv], or its bf16 planes [P, B, K, nv]: the tensor-core
    count's function on them (``count_from_planes_plain``), a bf16 Xv_b as
    its one plane and a float32 one rounded into P."""
    if Z.dim() == 4:
        _check_factor_planes(Xv_b, Z, PR.resolve(precision))
        a = (Xv_b.unsqueeze(0) if Xv_b.dtype == torch.bfloat16
             else bf16_planes_plain(Xv_b, Z.shape[0]))
        return count_from_planes_plain(a, Z)
    return M.pairwise_acc_from_sim(PR.matmul(Xv_b, Z, precision))


def count_from_planes_plain(a_planes: torch.Tensor, b_planes: torch.Tensor) -> torch.Tensor:
    """The tensor-core count's function on bf16 planes: pairwise accuracy
    [B] of ``sim = sum over plane pairs pa + pb <= 1 of A[pa] @ Bm[pb]`` (exact
    products, float32 sums), A ``[PA, B, nv, K]``, Bm ``[PB, B or 1, K, nv]``."""
    a = a_planes.to(torch.float32)
    bm = b_planes.to(torch.float32)
    sim = sum(a[pa] @ bm[pb] for pa in range(a.shape[0]) for pb in range(bm.shape[0])
              if pa + pb <= 1)
    return M.pairwise_acc_from_sim(sim)


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
    if precision != "highest":  # the unit latents' bf16 planes [P, 1, D, nv], once a call
        y_p = bf16_planes(_unit_rows(latents).mT.unsqueeze(0), PLANES[precision])
        return _count_tc(name, preds, y_p, True, b, nv, d, precision)
    # Bm[b, k, j] = y[j, k], shared by every vertex (batch stride 0), stored
    # [D, nv] with padded rows (a copy of nv x D floats, once per call): the
    # kernel reads it as it reads Z
    y_t = padded_empty(1, d, nv, preds.device)[0].copy_(_unit_rows(latents).mT)
    return _count_on_card(name, preds, y_t, (0, y_t.stride(0), 1), b, nv, d, precision)


def _check_factor_planes(Xv_b: torch.Tensor, Z: torch.Tensor, precision: str) -> None:
    """Z's planes must be bf16 [PLANES[precision], B, K, nv]: one plane at
    high would silently count another function."""
    planes = PLANES.get(precision)
    ok = (planes is not None and Xv_b.dim() == 3 and Z.dim() == 4 and Z.shape[0] == planes
          and tuple(Z.shape[1:]) == (Xv_b.shape[0], Xv_b.shape[2], Xv_b.shape[1]))
    _check_shapes("streamed_acc_from_factors",
                  f"Xv_b [B, nv, K] and Z's bf16 planes [{planes}, B, K, nv] at {precision!r}"
                  if planes else f"a float32 Z [B, K, nv] at {precision!r} (planes are "
                  f"taken at {tuple(PLANES)})", ok, Xv_b, Z)
    if Z.dtype != torch.bfloat16:
        raise TypeError(f"streamed_acc_from_factors: Z's planes are bf16; got {Z.dtype}")


def streamed_acc_from_factors(Xv_b: torch.Tensor, Z: torch.Tensor,
                              precision="highest") -> torch.Tensor:
    """Pairwise accuracy [B] of sim = Xv_b [B, nv, K] @ Z [B, K, nv].

    At ``"default"`` / ``"high"`` Z may be its bf16 planes ``[P, B, K, nv]``
    (``factor_planes``; P = ``PLANES[precision]``), which the count reads as
    they are (on the card in a layout ``planes_eligible`` accepts, as
    ``padded_planes`` lays them out); a float32 Z is rounded into planes
    first, as the JAX function's kernel rounds it.
    """
    name = "streamed_acc_from_factors"
    precision = PR.resolve(precision)
    if Z.dim() == 4:
        _check_factor_planes(Xv_b, Z, precision)
        if not _uses_kernel(name, Xv_b, Z, others_dtype=torch.bfloat16):
            return streamed_acc_from_factors_plain(Xv_b, Z, precision)
        if not planes_eligible(Z):
            raise ValueError(f"{name}: Z's planes {tuple(Z.shape)} at strides {Z.stride()} "
                             f"are not in padded_planes' layout, which the count loads")
        b, nv, k = Xv_b.shape
        return _count_tc(name, Xv_b, Z, False, b, nv, k, precision)
    _check_shapes(name, "Xv_b [B, nv, K] and Z [B, K, nv]",
                  Xv_b.dim() == 3 and Z.dim() == 3 and Z.shape[0] == Xv_b.shape[0]
                  and Z.shape[1] == Xv_b.shape[2] and Z.shape[2] == Xv_b.shape[1], Xv_b, Z)
    if not _uses_kernel(name, Xv_b, Z):
        return streamed_acc_from_factors_plain(Xv_b, Z, precision)
    b, nv, k = Xv_b.shape
    if precision != "highest":
        return _count_tc(name, Xv_b, bf16_planes(Z, PLANES[precision]), False, b, nv, k,
                         precision)
    return _count_on_card(name, Xv_b, Z, Z.stride(), b, nv, k, precision)


def streamed_acc_from_inv(Xv_b: torch.Tensor, inv: torch.Tensor, U: torch.Tensor,
                          precision="highest") -> torch.Tensor:
    """Pairwise accuracy [B] of sim = Xv_b [B, nv, K] @ (inv [B, K, K] @ U [B, K, nv]).

    On the card ``Z = inv U`` is formed by the source's own GEMM kernel into
    a padded workspace and read back by the count kernel (one call), both at
    ``precision``: at ``"default"`` inv and U are rounded for Z, and Z again
    for the count, as the TPU kernel's two dots round them (the tensor-core
    Z GEMM writes Z rounded, in bf16 planes).
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
    if precision != "highest":
        return _count_tc(name, Xv_b, Z, False, b, nv, k, precision)
    return _count_on_card(name, Xv_b, Z, Z.stride(), b, nv, k, precision)
