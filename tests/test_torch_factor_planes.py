"""Z handed to streamed_acc_from_factors as bf16 planes, checked on the CPU.

At ``"default"`` and ``"high"`` the selection path's ``fused-pallas`` scorer
forms Z = inv U with ``HM.factor_planes`` straight into bf16 planes ``[P, B,
K, nv]`` (hi; and lo = bf16(Z - hi) at high), and ``streamed_acc_from_factors``
reads them as they are.  On the CPU ``factor_planes`` is
``bf16_planes_plain(PR.matmul(inv, U, p), P)`` and the count on planes is
``count_from_planes_plain``; here they are held to the JAX package's Pallas
``streamed_acc_from_factors`` (interpret mode, with the TPU's bf16 passes
through ``_tpu_dots``) on the float32 Z the planes were rounded from, and the
engine's ``fused-pallas`` to its float32-Z route and to ``fused-inv``.

Bars: counts equal on integer inputs (|x| <= 16: bf16 holds them and float32
sums them exactly); within 1e-6 on Gaussian ones, the bar of
tests/test_torch_precision.py (the two sides sum the same exact bf16
products in other orders, which moves only near-ties, each by 1/(nv^2 -
nv)); the selection's alphas and CV scores equal, since both routes count
the same rounded Z.
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import pallas_metrics as JP
from multimodal_decoding_tpu_torch.decoding import searchlight_engine as TE
from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
from multimodal_decoding_tpu_torch.ops import precision as PR
from tests.test_torch_precision import _bf16, _counts_inputs, _tpu_dots

ACC_TOL = 1e-6
JAX_PRECISION = {"default": jax.lax.Precision.DEFAULT, "high": jax.lax.Precision.HIGH}
SHAPES = [(2, 7, 5), (3, 130, 17), (2, 300, 40)]  # (B, nv, K); nv crosses the JAX tiles


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("precision", ["default", "high"])
def test_factor_planes_plain_is_the_rounded_product(precision, kind):
    """Bit for bit bf16_planes_plain of PR.matmul(inv, U, p), in padded_planes
    rows the count loads as they are."""
    b, nv, k = 3, 130, 17
    _, _, _, inv, U = (torch.as_tensor(a) for a in _counts_inputs(kind, b, nv, k, seed=11))
    planes = HM.PLANES[precision]
    got = HM.factor_planes(inv, U, precision)
    ref = HM.bf16_planes_plain(PR.matmul(inv, U, precision), planes)
    assert got.dtype == torch.bfloat16 and got.shape == (planes, b, k, nv)
    assert torch.equal(got, ref) and HM.planes_eligible(got)
    hi, lo = PR.split_bf16(PR.matmul(inv, U, precision))
    assert torch.equal(got[0].to(torch.float32), hi)
    if planes == 2:
        assert torch.equal(got[1].to(torch.float32), lo)
    assert HM.launches == dict.fromkeys(HM.KERNELS, 0)  # not a launch, and the CPU counts none


@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["default", "high"])
def test_counts_on_z_planes_match_the_jax_kernel(precision, shape, kind, a_dtype):
    """The count on Z's planes against JAX's Pallas kernel on the float32 Z
    they were rounded from (TPU passes: Z rounded, or split into hi and lo,
    inside the kernel), a bf16 first operand as JAX sees it: rounded."""
    b, nv, k = shape
    _, _, Xv_b, _, Z = _counts_inputs(kind, b, nv, k, seed=sum(shape) + 2)
    if a_dtype == "bfloat16":
        Xv_b = _bf16(Xv_b)
    first = torch.as_tensor(Xv_b).to(getattr(torch, a_dtype))
    z_planes = HM.bf16_planes(torch.as_tensor(Z), HM.PLANES[precision])
    HM.reset_launches()
    got = HM.streamed_acc_from_factors(first, z_planes, precision).numpy()
    with _tpu_dots():
        ref = np.asarray(JP.streamed_acc_from_factors(
            Xv_b, Z, precision=JAX_PRECISION[precision], interpret=True))
    assert got.dtype == np.float32 and got.shape == (b,)
    if kind == "integer":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ACC_TOL)
    # the plain version takes the same planes; the float32 Z gives the same counts
    np.testing.assert_array_equal(
        got, HM.streamed_acc_from_factors_plain(first, z_planes, precision).numpy())
    np.testing.assert_array_equal(
        got, HM.streamed_acc_from_factors(first, torch.as_tensor(Z), precision).numpy())
    assert HM.launches == dict.fromkeys(HM.KERNELS, 0)


def _selection_inputs(seed=5):
    rng = np.random.RandomState(seed)
    n, k, d, v = 90, 10, 12, 16
    Y = rng.randn(n, d).astype(np.float32)
    X = (Y @ (rng.randn(d, v) * 0.4) + rng.randn(n, v)).astype(np.float32)
    adj = np.stack([rng.choice(v, size=k, replace=False) for _ in range(v)]).astype(np.int32)
    patches = TE.gather_patches(torch.as_tensor(X), torch.as_tensor(adj))
    return patches, torch.as_tensor(Y), torch.as_tensor([1.0, 1e1, 1e2, 1e3, 1e4])


@pytest.mark.parametrize("precision", ["default", "high"])
def test_fused_pallas_on_z_planes_selects_as_before_and_as_fused_inv(precision, monkeypatch):
    """fit_block_cv(cv_scorer="fused-pallas") with bf16 storage: Z's planes
    from factor_planes give the alphas and CV scores of the float32-Z route
    (Z formed at cv_precision, rounded inside the count) and of fused-inv,
    which forms the same Z inside its call."""
    patches, Y, alphas = _selection_inputs()
    kw = dict(cv_solver="schur-cb", cv_precision=precision, cv_dtype=torch.bfloat16)
    calls = []
    real = HM.factor_planes

    def recording(inv, U, p):
        calls.append(p)
        return real(inv, U, p)

    monkeypatch.setattr(HM, "factor_planes", recording)
    _, best, scores = TE.fit_block_cv(patches, Y, alphas, cv_scorer="fused-pallas", **kw)
    assert calls == [precision] * (5 * len(alphas))  # every (fold, alpha) takes planes
    # the float32-Z route: Z = inv U at cv_precision, handed over in float32
    monkeypatch.setattr(HM, "factor_planes", lambda inv, U, p: PR.matmul(inv, U, p))
    _, best_f32, scores_f32 = TE.fit_block_cv(patches, Y, alphas, cv_scorer="fused-pallas",
                                              **kw)
    monkeypatch.undo()
    _, best_inv, scores_inv = TE.fit_block_cv(patches, Y, alphas, cv_scorer="fused-inv", **kw)
    assert torch.isfinite(scores).all() and scores.shape == (16, len(alphas))
    for b_ref, s_ref in ((best_f32, scores_f32), (best_inv, scores_inv)):
        assert torch.equal(best, b_ref)
        assert torch.equal(scores, s_ref)


def test_fused_pallas_at_highest_keeps_the_float32_z(monkeypatch):
    """At "highest" fused-pallas keeps its float32 Z and the SIMT count."""
    patches, Y, alphas = _selection_inputs()

    def refuse(*args):
        raise AssertionError("factor_planes called at highest")

    monkeypatch.setattr(HM, "factor_planes", refuse)
    _, best, scores = TE.fit_block_cv(patches, Y, alphas, cv_scorer="fused-pallas",
                                      cv_solver="schur-cb")
    _, best_ref, _ = TE.fit_block_cv(patches, Y, alphas, cv_solver="schur-cb")
    assert torch.isfinite(scores).all() and (best == best_ref).float().mean() >= 0.9


@pytest.mark.parametrize("case", ["one_plane_at_high", "two_planes_at_default",
                                  "planes_at_highest", "transposed", "batch", "float32"])
def test_wrong_z_planes_raise(case):
    """A plane count that is not PLANES[precision] would count another
    function (one plane at high drops Z's low part): it raises, with the
    shapes in the message, as do planes of the wrong shape or dtype."""
    b, nv, k = 2, 9, 5
    Xv_b = torch.zeros(b, nv, k)
    planes = {"one_plane_at_high": (1, "high"), "two_planes_at_default": (2, "default"),
              "planes_at_highest": (1, "highest")}
    if case in planes:
        p, precision = planes[case]
        Z, error = torch.zeros(p, b, k, nv, dtype=torch.bfloat16), ValueError
    else:
        precision, error = "default", ValueError
        Z = {"transposed": torch.zeros(1, b, nv, k, dtype=torch.bfloat16),
             "batch": torch.zeros(1, b + 1, k, nv, dtype=torch.bfloat16),
             "float32": torch.zeros(1, b, k, nv)}[case]
        if case == "float32":
            error = TypeError
    shapes = rf"\({b}, {nv}, {k}\), \({', '.join(map(str, Z.shape))}\)"
    match = "bf16" if error is TypeError else shapes
    with pytest.raises(error, match=match):
        HM.streamed_acc_from_factors(Xv_b, Z, precision)
    with pytest.raises(error, match=match):
        HM.streamed_acc_from_factors_plain(Xv_b, Z, precision)


def test_factor_planes_rejects_what_it_does_not_take():
    inv, U = torch.zeros(2, 5, 5), torch.zeros(2, 5, 9)
    with pytest.raises(ValueError, match="forms bf16 planes"):
        HM.factor_planes(inv, U, "highest")
    with pytest.raises(ValueError, match=r"inv \[B, K, K\]"):
        HM.factor_planes(inv, U.mT, "default")
    with pytest.raises(ValueError, match="several devices"):
        HM.factor_planes(inv, U.to("meta"), "default")


def test_planes_eligible_rule():
    """The count loads Z's planes by tensor map as they are where rows hold
    whole 64-column blocks (padded_planes' layout, which factor_planes
    writes); the wrapper refuses planes in any other layout on the card."""
    padded = HM.padded_planes(2, 3, 5, 100, "cpu")
    assert HM.planes_eligible(padded) and HM.planes_eligible(padded[:1])
    assert not HM.planes_eligible(padded.to(torch.float32))             # not bf16
    assert not HM.planes_eligible(torch.zeros(1, 3, 5, 100, dtype=torch.bfloat16))  # rows of 100
    assert HM.planes_eligible(torch.zeros(1, 3, 5, 64, dtype=torch.bfloat16))
    assert not HM.planes_eligible(padded.mT)                            # nv not contiguous
    assert not HM.planes_eligible(padded[..., 1:])                      # base 2 bytes off
    assert HM.planes_eligible(padded[..., :1])                          # one column
