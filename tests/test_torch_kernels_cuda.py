"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, where no CUDA device is
present (the CPU tier-1 run).  On a machine with an H100 run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the GPU machine need
not have.)

chip_smoke.py's kernel phase makes the same comparison at the main path's
shapes in every chip run.
"""

import pytest
import torch

from multimodal_decoding_tpu_torch.ops import hopper_solvers as H

pytestmark = pytest.mark.cuda

REL_TOL = 1e-4  # max |kernel - plain| / max |plain|, float32 sums in another order


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _spd(b, pb, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((b, 4 * pb + 8, pb), generator=gen, device=device)
    return X.mT @ X + pb * torch.eye(pb, device=device)


@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("pb", [6, 64, 187, 188, 192])
def test_chol_inv_panel_kernel_matches_plain(cuda, b, pb):
    A = _spd(b, pb, seed=pb, device=cuda)
    before = H.launches
    got = H.chol_inv_panel(A)
    torch.cuda.synchronize()
    assert H.launches == before + 1
    ref = H.chol_inv_panel_plain(A)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= REL_TOL, rel
    assert torch.all(torch.triu(got, 1) == 0)


def test_chol_inv_panel_kernel_reads_only_the_lower_triangle(cuda):
    A = _spd(4, 100, seed=1, device=cuda)
    junk = A + torch.triu(torch.full_like(A, float("nan")), 1)
    torch.testing.assert_close(H.chol_inv_panel(junk), H.chol_inv_panel(A), rtol=0, atol=0)


def test_chol_inv_panel_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="PB <= 192"):
        H.chol_inv_panel(torch.eye(193, device=cuda)[None])
    with pytest.raises(TypeError, match="float32"):
        H.chol_inv_panel(torch.eye(8, device=cuda, dtype=torch.float64)[None])
    with pytest.raises(ValueError, match="contiguous"):
        H.chol_inv_panel(torch.eye(8, device=cuda)[None].expand(2, 8, 8))
