"""The upstream searchlight's 16-bit deployment for a sample of vertices,
written plainly, under the contract the port's ``--fast-math`` states.

Upstream casts the betas and the latents to float16 before it fits
(``searchlight.py:247-248``) and runs its CLI's fixed alpha.  The contract,
product by product:

* the betas are rounded to bf16 (``x.to(torch.bfloat16).to(torch.float32)``);
* every product with a patch of them is one bf16 pass: its operands rounded
  to bf16, then a float32 matmul (exact products, float32 sums).  That is
  the patch gram, X^T Y (the train latents rounded as its operand) and the
  test and imagery predictions (the weights rounded as theirs);
* the ridge solve is a float32 Cholesky, as ``plain.py`` does it;
* the scores' and the nulls' cosine distances are float32 products of the
  float32 predictions and latents.

The functions are ``searchlight.py``'s, run on betas that carry the product
(``Betas``): every matmul with a patch cut from them goes through it, and
its result is a plain tensor, so the solve and the scores stay float32.

Departures from the upstream:

* bf16 (8 mantissa bits) where the upstream rounds to float16 (11), as the
  port's ``--fast-math`` stores them;
* the latents are not rounded where they meet the predictions: the port
  keeps them float32 there, and rounds the train latents only as an
  operand of X^T Y;
* the upstream's fit and scores then run in float64 (sklearn, scipy's
  cdist); here the sums are float32, as on the port.

``OutputsInBf16`` is the control, one precision below the contract: each
such product's output is rounded to bf16 as well.
"""

from __future__ import annotations

import torch

from portbench.reference import searchlight as SL


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at one bf16 pass: operands rounded to bf16, float32 matmul."""
    return round_bf16(a) @ round_bf16(b)


def bf16_outputs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: one bf16 pass with its output rounded to bf16."""
    return round_bf16(bf16_pass(a, b))


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class Betas(torch.Tensor):
    """Betas whose every patch multiplies by ``product`` (``bf16_pass``, or
    under ``OutputsInBf16`` the control's), with plain results."""

    product = staticmethod(bf16_pass)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            return cls.product(*(x.as_subclass(torch.Tensor) for x in args))
        return super().__torch_function__(func, types, args, kwargs or {})


class OutputsInBf16:
    """The control while open: every product with a patch rounds its output
    to bf16 too (restored on exit)."""

    def __enter__(self):
        self.saved = Betas.product
        Betas.product = staticmethod(bf16_outputs)
        return self

    def __exit__(self, *exc):
        Betas.product = self.saved
        return False


def vertices(X_all: torch.Tensor, neighbours: torch.Tensor, Y_train, Y_test, Y_imag,
             caption_rows, image_rows, shuffles, derangement_choices, alpha: float,
             chunk: int = 16) -> dict:
    """``reference/searchlight.vertices`` at a fixed ``alpha`` under the
    contract.  ``X_all`` may be of any float dtype: its patches enter
    nothing but their products, which round them to bf16."""
    return SL.vertices(X_all.as_subclass(Betas), neighbours, Y_train, Y_test, Y_imag,
                       caption_rows, image_rows, shuffles, derangement_choices, alpha=alpha,
                       chunk=chunk)
