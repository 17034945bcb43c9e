"""What the tensor-core streamed counts take from Python, checked on the CPU.

The ``"default"`` and ``"high"`` variants of the streamed counts read bf16
planes: ``hi = bf16(x)`` and, at high, ``lo = bf16(x - hi)``, each rounded
once (``HM.bf16_planes``), in rows padded to 64 elements (128 bytes,
``HM.padded_planes``).  The kernel loads every operand by tensor map: the
wrapper hands a bf16 first operand over as it is where ``HM.tma_eligible``
holds and as a padded copy (``HM.padded_copy``) otherwise, and the engine
hands the fused scorers' bf16 fold patches over in padded rows.  ``HM.count_from_planes_plain`` is the
kernel's function on the planes; fed the port's planes it gives the JAX
package's Pallas kernels at DEFAULT and HIGH (interpret mode, with the TPU's
bf16 passes through ``_tpu_dots``).

Bars: rounding bit for bit against ml_dtypes' bfloat16; counts equal on
integer inputs (|x| <= 16: bf16 holds them and float32 sums them exactly),
within 1e-6 on Gaussian ones (tests/test_torch_precision.py's bar).
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import pallas_metrics as JP
from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
from multimodal_decoding_tpu_torch.ops import precision as PR
from tests.test_torch_precision import _counts_inputs, _tpu_dots

ACC_TOL = 1e-6
JAX_PRECISION = {"default": jax.lax.Precision.DEFAULT, "high": jax.lax.Precision.HIGH}


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _planes_np(x: np.ndarray, planes: int) -> list:
    hi = _bf16(x)
    return [hi] if planes == 1 else [hi, _bf16(np.asarray(x, np.float32) - hi)]


@pytest.mark.parametrize("cols", [1, 7, 8, 9, 1639])
@pytest.mark.parametrize("planes", [1, 2])
def test_padded_planes_rows_start_128_bytes_apart(planes, cols):
    x = HM.padded_planes(planes, 3, 5, cols, "cpu")
    assert x.shape == (planes, 3, 5, cols) and x.dtype == torch.bfloat16
    ld = x.stride(2)
    assert x.stride(3) == 1 and ld % 64 == 0 and 0 <= ld - cols < 64
    assert x.stride(1) == 5 * ld and x.stride(0) == 3 * 5 * ld


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("view", ["contiguous", "transposed", "strided"])
def test_bf16_planes_round_once_to_nearest_even(view, planes):
    """hi = bf16(x) and lo = bf16(x - hi) as ml_dtypes rounds them, from any
    strides (the latents reach it as a transposed view), into padded rows;
    lo is what ops/precision.split_bf16 gives."""
    rng = np.random.default_rng(planes)
    base = (rng.standard_normal((2, 37, 41)) * 10.0 ** rng.uniform(-3, 3, (2, 37, 41)))
    x = torch.as_tensor(base.astype(np.float32))
    x = {"contiguous": x, "transposed": x.mT, "strided": x[:, ::2, 1::3]}[view]
    got = HM.bf16_planes(x, planes)
    assert got.shape == (planes, *x.shape) and got.stride(2) % 64 == 0
    for g, ref in zip(got, _planes_np(x.numpy(), planes)):
        np.testing.assert_array_equal(g.to(torch.float32).numpy(), ref)
    hi, lo = PR.split_bf16(x)
    assert torch.equal(got[0].to(torch.float32), hi)
    if planes == 2:
        assert torch.equal(got[1].to(torch.float32), lo)


def test_bf16_planes_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="1 or 2 planes"):
        HM.bf16_planes(torch.zeros(2, 3, 4), 3)
    with pytest.raises(ValueError, match=r"\[B, R, C\]"):
        HM.bf16_planes(torch.zeros(3, 4), 1)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_z_planes_are_the_rounding_of_the_tpu_dot(precision):
    """B4's Z in planes is what the count's rounding of the float32 Z = inv U
    gives: at default one bf16 Z (what ops/precision rounds again for the
    second dot), at high its hi and lo parts; the counts over them are the
    plain version's, bit for bit."""
    rng = np.random.default_rng(4)
    b, nv, k = 3, 50, 24
    Xv_b = torch.as_tensor(rng.standard_normal((b, nv, k), dtype=np.float32))
    inv = torch.as_tensor(rng.standard_normal((b, k, k), dtype=np.float32) / k)
    U = torch.as_tensor(rng.standard_normal((b, k, nv), dtype=np.float32))
    planes = HM.PLANES[precision]
    Z = PR.matmul(inv, U, precision)
    Zp = HM.bf16_planes(Z, planes)
    if precision == "default":
        assert torch.equal(Zp[0].to(torch.float32), PR.round_bf16(Z))
    else:
        hi, lo = PR.split_bf16(Z)
        assert torch.equal(Zp[0].to(torch.float32), hi)
        assert torch.equal(Zp[1].to(torch.float32), lo)
    got = HM.count_from_planes_plain(HM.bf16_planes(Xv_b, planes), Zp)
    assert torch.equal(got, HM.streamed_acc_from_inv_plain(Xv_b, inv, U, precision))


@pytest.mark.parametrize("k", [16, 17, 750])
def test_padded_copy_makes_the_fold_patches_tma_eligible(k):
    """The fold patches reach the kernel as Xv_b = Xv.permute(1, 0, 2) of a
    [nv, B, K] slice: its vertex stride is K elements, which a tensor map
    takes only where 2 K is a multiple of 16 bytes.  In padded_copy's rows it
    always is, with the same values."""
    Xv = torch.randn(9, 4, k).to(torch.bfloat16)
    view = Xv.permute(1, 0, 2).unsqueeze(0)
    assert HM.tma_eligible(view) == (k % 8 == 0)
    padded = HM.padded_copy(Xv, torch.bfloat16)
    assert torch.equal(padded, Xv) and padded.stride(1) % 64 == 0
    assert HM.tma_eligible(padded.permute(1, 0, 2).unsqueeze(0))


@pytest.mark.parametrize("view", ["k_strided", "base_2_bytes_off", "rows_of_40_bytes"])
def test_padded_copy_of_a_view_a_tensor_map_cannot_describe(view):
    """The count's rule for a bf16 first operand that is not tma_eligible:
    it reads padded_copy(a), which always is, with the same values."""
    base = torch.randn(6, 5, 24).to(torch.bfloat16)
    a = {"k_strided": base[..., ::2], "base_2_bytes_off": base[..., 1:],
         "rows_of_40_bytes": base[..., :20].contiguous()}[view]
    assert not HM.tma_eligible(a)
    padded = HM.padded_copy(a, torch.bfloat16)
    assert HM.tma_eligible(padded) and torch.equal(padded, a)
    assert padded.stride(-2) % 64 == 0


def test_tma_eligible_rule_on_strides_and_alignment():
    """The wrapper's rule, never a try: bf16, k contiguous, a 16-byte-aligned
    base, and every other axis longer than 1 strided by a positive multiple
    of 8 elements below 2^40 bytes."""
    preds = torch.zeros((1, 6, 5, 1024), dtype=torch.bfloat16)
    assert HM.tma_eligible(preds)
    assert not HM.tma_eligible(preds.to(torch.float32))            # not bf16
    assert not HM.tma_eligible(preds.mT)                           # k not contiguous
    assert not HM.tma_eligible(preds[..., 1:])                     # base 2 bytes off
    assert HM.tma_eligible(preds[..., 8:])                         # base 16 bytes on
    assert not HM.tma_eligible(preds[..., :1020].contiguous())     # rows of 2040 bytes
    rows = torch.zeros((1, 6, 5, 20), dtype=torch.bfloat16)        # rows of 40 bytes
    assert not HM.tma_eligible(rows)
    assert not HM.tma_eligible(rows[:, :, :1])                     # vertices 200 bytes apart
    assert HM.tma_eligible(rows[:, :1, :1])                        # one row: never stepped
    assert HM.tma_eligible(torch.zeros((1, 1, 1, 3), dtype=torch.bfloat16))
    planes = HM.padded_planes(2, 3, 7, 13, "cpu")
    assert HM.tma_eligible(planes) and HM.tma_eligible(planes[:1])


@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("precision", ["default", "high"])
def test_counts_from_planes_equal_the_plain_versions(precision, kind, a_dtype):
    """count_from_planes_plain on the wrapper's planes (a bf16 first operand
    as one plane, a float32 one split like the others) gives the plain
    versions' counts: bit for bit on integers, within 1e-6 on Gaussians."""
    b, nv, k = 3, 130, 17
    preds, y, Xv_b, inv, U = (torch.as_tensor(a) for a in _counts_inputs(kind, b, nv, k, 7))
    planes = HM.PLANES[precision]

    def first(x):
        x = x.to(getattr(torch, a_dtype))
        return x.unsqueeze(0) if x.dtype == torch.bfloat16 else HM.bf16_planes(x, planes)

    y_p = HM.bf16_planes(HM._unit_rows(y).mT.unsqueeze(0), planes)
    cases = [
        (HM.count_from_planes_plain(first(preds), y_p),
         HM.streamed_pairwise_acc_plain(preds.to(getattr(torch, a_dtype)), y, precision)),
        (HM.count_from_planes_plain(first(Xv_b), HM.bf16_planes(U, planes)),
         HM.streamed_acc_from_factors_plain(Xv_b.to(getattr(torch, a_dtype)), U, precision)),
        (HM.count_from_planes_plain(first(Xv_b),
                                    HM.bf16_planes(PR.matmul(inv, U, precision), planes)),
         HM.streamed_acc_from_inv_plain(Xv_b.to(getattr(torch, a_dtype)), inv, U, precision)),
    ]
    for got, ref in cases:
        if kind == "integer":
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=0, atol=ACC_TOL)


SHAPES = [(2, 7, 5), (3, 130, 17), (2, 300, 40)]  # (B, nv, K); nv crosses the JAX tiles


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["default", "high"])
def test_counts_from_planes_match_the_jax_kernels(precision, shape, kind):
    """The port's planes through count_from_planes_plain against the JAX
    package's three Pallas kernels at DEFAULT and HIGH, in interpret mode
    with the TPU's bf16 passes (_tpu_dots): the float32 first operand split
    like the rest, B4's Z from ops/precision's rounded product."""
    b, nv, k = shape
    preds, y, Xv_b, inv, U = _counts_inputs(kind, b, nv, k, seed=sum(shape) + 1)
    planes = HM.PLANES[precision]
    t = torch.as_tensor
    jp = JAX_PRECISION[precision]
    with _tpu_dots():
        ref_b3 = np.asarray(JP.streamed_pairwise_acc(preds, y, precision=jp, interpret=True))
        ref_b5 = np.asarray(JP.streamed_acc_from_factors(Xv_b, U, precision=jp, interpret=True))
        ref_b4 = np.asarray(JP.streamed_acc_from_inv(Xv_b, inv, U, precision=jp,
                                                     interpret=True))
    y_p = HM.bf16_planes(HM._unit_rows(t(y)).mT.unsqueeze(0), planes)
    x_p = HM.bf16_planes(t(Xv_b), planes)
    got = {
        "B3": HM.count_from_planes_plain(HM.bf16_planes(t(preds), planes), y_p),
        "B5": HM.count_from_planes_plain(x_p, HM.bf16_planes(t(U), planes)),
        "B4": HM.count_from_planes_plain(
            x_p, HM.bf16_planes(PR.matmul(t(inv), t(U), precision), planes)),
    }
    for name, ref in (("B3", ref_b3), ("B5", ref_b5), ("B4", ref_b4)):
        g = got[name].numpy()
        assert g.dtype == np.float32 and g.shape == ref.shape, name
        if kind == "integer":
            np.testing.assert_array_equal(g, ref, err_msg=name)
        else:
            np.testing.assert_allclose(g, ref, rtol=0, atol=ACC_TOL, err_msg=name)
