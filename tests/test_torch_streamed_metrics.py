"""Port parity: the streamed-count scorers against the JAX package's Pallas kernels.

``ops/hopper_metrics`` runs its ``*_plain`` versions on CPU tensors; the JAX
functions in ``ops/pallas_metrics.py`` run their Pallas kernels in interpret
mode, as the JAX package's own tests run them off the TPU.  The same seeded
numpy inputs go to both.

Tolerances: on integer-valued inputs every product is exact in float32 and
many comparisons are exact ties, so the strict ``<`` is tested and the
accuracies must be EQUAL.  On Gaussian inputs they agree within 1e-6, the
JAX package's own bar (tests/test_searchlight.py).  nv = 300 is no multiple
of any tile and crosses the JAX kernels' row tiles (128 and 256).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.ops import pallas_metrics as JP
from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

HIGHEST = jax.lax.Precision.HIGHEST
SHAPES = [(2, 7, 5), (3, 130, 17), (5, 300, 40)]  # (B, nv, K)
D = 48


def _unit_norm_integer_latents(rng, nv, d):
    """Rows of sixteen +-1 entries: the norm is exactly 4, so unit rows are exact."""
    y = np.zeros((nv, d), np.float32)
    for i in range(nv):
        y[i, rng.choice(d, 16, replace=False)] = rng.choice([-1.0, 1.0], 16)
    return y


def _inputs(kind, b, nv, k, seed):
    rng = np.random.RandomState(seed)

    def draw(*shape):
        if kind == "integer":
            return rng.randint(-3, 4, shape).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)

    latents = (_unit_norm_integer_latents(rng, nv, D) if kind == "integer"
               else draw(nv, D))
    return {
        "streamed_pairwise_acc": (draw(b, nv, D), latents),
        "streamed_acc_from_inv": (draw(b, nv, k), draw(b, k, k), draw(b, k, nv)),
        "streamed_acc_from_factors": (draw(b, nv, k), draw(b, k, nv)),
    }


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", HM.KERNELS)
def test_plain_matches_jax_kernel(name, shape, kind):
    args = _inputs(kind, *shape, seed=sum(shape))[name]
    ref = np.asarray(getattr(JP, name)(*args, precision=HIGHEST, interpret=True))
    HM.reset_launches()
    got = getattr(HM, name)(*map(torch.as_tensor, args))
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0],)
    if kind == "integer":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # the CPU path is the plain version, which counts no launch
    np.testing.assert_array_equal(got.numpy(), getattr(HM, name + "_plain")(
        *map(torch.as_tensor, args)).numpy())
    assert HM.launches == dict.fromkeys(HM.KERNELS, 0)


def test_integer_inputs_hold_exact_ties():
    """The integer inputs really test the strict ``<``: many rows tie their diagonal."""
    b, nv, k = SHAPES[-1]
    x, z = _inputs("integer", b, nv, k, seed=0)["streamed_acc_from_factors"]
    sim = np.einsum("bik,bkj->bij", x.astype(np.float64), z)
    diag = np.diagonal(sim, axis1=-2, axis2=-1)[..., None]
    ties = (sim == diag).sum() - b * nv
    assert ties > b * nv, ties


def test_pairwise_acc_equals_cosine_accuracy():
    """streamed_pairwise_acc is the cosine pairwise accuracy, rows of preds unscaled."""
    from multimodal_decoding_tpu_torch.ops import metrics as M

    rng = np.random.RandomState(3)
    preds = torch.as_tensor(rng.randn(4, 60, D).astype(np.float32))
    latents = torch.as_tensor(rng.randn(60, D).astype(np.float32))
    dense = M.pairwise_acc_from_dist(M.cosine_distances(preds, latents))
    torch.testing.assert_close(HM.streamed_pairwise_acc(preds, latents), dense,
                               rtol=0, atol=1e-6)


def test_wrappers_reject_what_they_do_not_take():
    x = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match=r"preds \[B, nv, D\]"):
        HM.streamed_pairwise_acc(x, torch.zeros(4, 3))
    with pytest.raises(ValueError, match=r"Z \[B, K, nv\]"):
        HM.streamed_acc_from_factors(x, torch.zeros(2, 5, 3))
    with pytest.raises(ValueError, match=r"inv \[B, K, K\]"):
        HM.streamed_acc_from_inv(x, torch.zeros(2, 3, 4), torch.zeros(2, 3, 5))
    meta = torch.zeros(2, 3, 5, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        HM.streamed_acc_from_factors(x.to("meta"), meta)
    with pytest.raises(ValueError, match="several devices"):
        HM.streamed_acc_from_factors(x, meta)
