"""How a product is computed at the JAX package's precisions, on every device.

The JAX package passes ``jax.lax.Precision`` to its products, and on a TPU
the name is a number of bf16 passes through the matrix unit.  The port keeps
the three names as strings and gives them the TPU's arithmetic on every
device, its CPU plain versions included:

* ``"highest"``: float32 operands, float32 accumulation (TF32 stays off,
  ``device.py``).  A bf16 operand is widened exactly.
* ``"default"``: one bf16 pass.  Each operand is rounded to bf16 (round to
  nearest even), the products are exact, accumulation and output are float32.
* ``"high"``: bf16 x 3.  ``x = hi + lo`` with ``hi = bf16(x)`` and
  ``lo = bf16(x - hi)``; ``hi.hi + hi.lo + lo.hi`` summed in float32.

(The JAX package on the CPU computes every precision in float32; the port's
CPU does not, so a test feeds JAX bf16-rounded operands at HIGHEST, which is
the same arithmetic.)

A product of rounded operands on the card goes to cuBLAS, as the JAX package
left products outside its kernels to XLA: ``torch.mm``/``torch.bmm`` of the
bf16 operands with ``out_dtype=torch.float32`` (broadcast batch dimensions
are folded into the rows or expanded first), each GEMM counted as
``mdt.precision.bf16`` (``utils/profiling.count``).  A bf16 operand at
``"default"`` goes to it as it is.  TF32 stays off throughout.

The selection path's shipped settings per device live here alone:
``default_cv_solver`` and ``default_wb_cv_solver`` (the searchlight's and
the whole-brain CV's solver), ``default_cv_precision`` and
``default_cv_dtype``.  The searchlight, the whole-brain CV and the sharded
step read them as the JAX package reads its per-platform functions.
"""

from __future__ import annotations

import torch

from multimodal_decoding_tpu_torch.device import resolve_device
from multimodal_decoding_tpu_torch.utils.profiling import count

PRECISIONS = ("highest", "high", "default")


def resolve(precision) -> str:
    """``precision`` checked against ``PRECISIONS`` (``None`` is ``"highest"``)."""
    if precision is None:
        return "highest"
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; use one of {PRECISIONS}")
    return precision


def default_cv_solver(device=None) -> str:
    """The searchlight's CV-selection solver for ``device`` (``None``: the
    default device).

    "schur-pallas" on CUDA, so the main path runs the hand-written panel
    kernel; chip_smoke.py's selection gate holds it to the strict path.
    Elsewhere "schur-cb", as the JAX package chooses off the TPU.
    """
    if device is None:
        on_cuda = torch.cuda.is_available()
    else:
        on_cuda = resolve_device(device).type == "cuda"
    return "schur-pallas" if on_cuda else "schur-cb"


def default_wb_cv_solver(device=None) -> str | None:
    """The whole-brain CV selection solver for ``device`` (``None``: cuda).

    "schur-pallas" on CUDA: its base blocks run the hand-written panel
    kernel, and chip_smoke.py's ``wb_gate`` phase holds it to the strict
    Cholesky oracle on planted-signal problems at production shape.  None
    (the strict oracle) on the CPU, as the JAX package chooses off the TPU.
    The refit is the strict Cholesky solve either way.
    """
    return "schur-pallas" if resolve_device(device).type == "cuda" else None


def default_cv_precision(device=None) -> str:
    """The selection path's shipped precision on ``device``: ``"highest"``.

    On CUDA and on the CPU alike: a narrower selection becomes a default only
    after it passes its gate on an H100 (chip_smoke.py, phase ``precision``).
    """
    del device  # the same on every device the port runs on, until a gate moves it
    return "highest"


def default_cv_dtype(device=None):
    """The selection path's shipped storage dtype on ``device``: float32 (``None``)."""
    del device
    return None


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x: torch.Tensor) -> tuple:
    """``(hi, lo)`` as float32: ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    x = x.to(torch.float32)
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def _rounded_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a @ b`` (``torch.matmul`` broadcasting, both at least 2-D) of
    bf16-exact operands (bf16 tensors, or float32 tensors holding bf16
    values): exact products, float32 sums.  On the card one cuBLAS bf16 GEMM
    with float32 output."""
    if a.device.type != "cuda":
        return a.to(torch.float32) @ b.to(torch.float32)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    count("mdt.precision.bf16", 1)
    m, n = a.shape[-2], b.shape[-1]
    if b.dim() == 2:  # a's batch folds into its rows
        c = torch.mm(a16.reshape(-1, a.shape[-1]), b16, out_dtype=torch.float32)
        return c.reshape(*a.shape[:-1], n)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a16.expand(*batch, *a.shape[-2:]).reshape(-1, m, a.shape[-1])
    b3 = b16.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(*batch, m, n)


def matmul(a: torch.Tensor, b: torch.Tensor, precision="highest", out=None,
           out_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` (``torch.matmul`` broadcasting) at ``precision``, float32 out
    (at ``"highest"``, operands of another float type keep it).

    ``out_dtype=torch.bfloat16`` is the JAX package's
    ``preferred_element_type=bfloat16``: both operands must then be bf16,
    and the product is ``torch.matmul``'s, rounded once at the end.
    ``out``: a float32 tensor (or view) the result is written into.
    """
    precision = resolve(precision)
    if out_dtype == torch.bfloat16:
        if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
            raise TypeError(f"a bf16 product takes bf16 operands; got {a.dtype}, {b.dtype}")
        return torch.matmul(a, b)
    if out_dtype != torch.float32:
        raise TypeError(f"out_dtype must be float32 or bfloat16; got {out_dtype}")
    if precision == "highest":
        # a bf16 operand widens exactly; other dtypes multiply as they are
        a = a.to(torch.float32) if a.dtype == torch.bfloat16 else a
        b = b.to(torch.float32) if b.dtype == torch.bfloat16 else b
        return torch.matmul(a, b, out=out)
    if precision == "default":
        c = _rounded_product(a.to(torch.bfloat16), b.to(torch.bfloat16))
    else:
        a_hi, a_lo = split_bf16(a)
        b_hi, b_lo = split_bf16(b)
        c = (_rounded_product(a_hi, b_hi) + _rounded_product(a_hi, b_lo)
             + _rounded_product(a_lo, b_hi))
    return c if out is None else out.copy_(c)
