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

from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
from multimodal_decoding_tpu_torch.ops import hopper_solvers as H
from multimodal_decoding_tpu_torch.ops import precision as PR

pytestmark = pytest.mark.cuda

REL_TOL = 1e-4  # max |kernel - plain| / max |plain|, float32 sums in another order
# streamed counts on Gaussian inputs: two float32 summation orders disagree
# only on near-ties; one flipped comparison moves an accuracy by 1/(nv^2 - nv)
ACC_TOL = 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _spd(b, pb, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((b, 4 * pb + 8, pb), generator=gen, device=device)
    return X.mT @ X + pb * torch.eye(pb, device=device)


# batch: one block, around one per SM (132 SMs), and more blocks than SMs;
# PB: at and around the 32-wide panels and the 4-wide register tiles
@pytest.mark.parametrize("b", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("pb", [1, 2, 6, 31, 32, 33, 63, 64, 65, 95, 96, 97, 160, 161,
                                187, 188, 192])
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


@pytest.mark.parametrize("alpha", [1e2, 1e7])
@pytest.mark.parametrize("pb", [187, 188])
def test_chol_inv_panel_kernel_at_production_alphas(cuda, pb, alpha):
    """Grams of 8192 rows plus alpha I, the ends of the production alpha grid."""
    gen = torch.Generator(device=cuda).manual_seed(pb)
    X = torch.randn((128, 8192, pb), generator=gen, device=cuda)
    A = X.mT @ X + alpha * torch.eye(pb, device=cuda)
    got, ref = H.chol_inv_panel(A), H.chol_inv_panel_plain(A)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= REL_TOL, rel


@pytest.mark.parametrize("alpha", [1e2, 1e7])
@pytest.mark.parametrize("pb", [99, 100, 101])
def test_chol_inv_panel_kernel_at_radius_shapes_with_a_masked_neighbour(cuda, pb, alpha):
    """Radius mode's base blocks at fsaverage7 density, [128, 99..101], at the
    ends of the production alpha grid, each with one masked neighbour: its
    row and column zero apart from alpha on the diagonal (a different one in
    each matrix), so L^-1 has 1/sqrt(alpha) there and zeros around it."""
    gen = torch.Generator(device=cuda).manual_seed(pb)
    X = torch.randn((128, 8192, pb), generator=gen, device=cuda)
    masked = torch.arange(128, device=cuda) % pb
    X[torch.arange(128, device=cuda), :, masked] = 0.0
    A = X.mT @ X + alpha * torch.eye(pb, device=cuda)
    got, ref = H.chol_inv_panel(A), H.chol_inv_panel_plain(A)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= REL_TOL, rel
    rows = torch.arange(128, device=cuda)
    diag = got[rows, masked, masked]
    torch.testing.assert_close(diag, torch.full_like(diag, alpha ** -0.5), rtol=1e-6, atol=0)
    got[rows, masked, masked] = 0.0
    assert torch.all(got[rows, masked, :] == 0) and torch.all(got[rows, :, masked] == 0)


@pytest.mark.parametrize("bad", [0, 100, 187])
def test_chol_inv_panel_kernel_gives_nan_on_a_block_that_is_not_spd(cuda, bad):
    """No pivoting: a negative pivot (in the first, a middle or the last
    panel) makes the block's output non-finite; the other blocks are right."""
    A = _spd(3, 188, seed=2, device=cuda)
    A[1, bad, bad] = -1.0
    got = H.chol_inv_panel(A)
    assert not torch.isfinite(got[1]).all()
    ref = H.chol_inv_panel_plain(A[[0, 2]])
    assert float((got[[0, 2]] - ref).abs().max() / ref.abs().max()) <= REL_TOL


@pytest.mark.parametrize("pb", [33, 65, 100, 161])
def test_chol_inv_panel_kernel_is_deterministic(cuda, pb):
    """Tiles are handed out at run time, yet every entry sums in one fixed
    order: repeated launches agree bit for bit.  At these PB the shared-memory
    row stride equals PB rounded up to 4, so a tile that wrote past its row
    would race with the next row's updates."""
    A = _spd(128, pb, seed=pb, device=cuda)
    first = H.chol_inv_panel(A)
    for _ in range(20):
        assert torch.equal(H.chol_inv_panel(A), first)


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


def _streamed_inputs(name, kind, b, nv, k, device):
    """Inputs of the streamed scorer ``name`` at depth ``k`` (D for
    streamed_pairwise_acc, K for the others).  Integer inputs keep every
    product exact in float32 (latent rows of sixteen +-1 entries have norm
    exactly 4; of one, 1)."""
    gen = torch.Generator(device=device).manual_seed(b * 7919 + nv * 31 + k)

    def draw(*shape):
        if kind == "integer":
            return torch.randint(-3, 4, shape, generator=gen, device=device).float()
        return torch.randn(shape, generator=gen, device=device)

    if name == "streamed_pairwise_acc":
        d = k
        if kind == "integer":
            keys = torch.rand((nv, d), generator=gen, device=device)
            top = keys.topk(min(16, d), dim=-1).indices
            signs = torch.randint(0, 2, top.shape, generator=gen, device=device).float() * 2 - 1
            latents = torch.zeros((nv, d), device=device).scatter_(1, top, signs)
        else:
            latents = draw(nv, d)
        return draw(b, nv, d), latents
    if name == "streamed_acc_from_inv":
        return draw(b, nv, k), draw(b, k, k), draw(b, k, nv)
    return draw(b, nv, k), draw(b, k, nv)


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("b,nv,k", [
    (1, 1, 1), (1, 7, 750), (128, 7, 1),
    # one tile exactly and one past it (128, 256 / 129, 257 rows and columns);
    # depth below, at and just past a pipeline stage (32 k)
    (2, 128, 32), (2, 129, 31), (2, 129, 33), (2, 256, 32), (3, 257, 33),
    (128, 256, 750), (1, 1639, 750), (128, 1639, 750), (128, 1639, 1024)])
@pytest.mark.parametrize("name", HM.KERNELS)
def test_streamed_kernel_matches_plain(cuda, name, b, nv, k, kind):
    args = _streamed_inputs(name, kind, b, nv, k, cuda)
    before = HM.launches[name]
    got = getattr(HM, name)(*args)
    torch.cuda.synchronize()
    assert HM.launches[name] == before + 1
    ref = getattr(HM, name + "_plain")(*args)
    if kind == "integer":
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=ACC_TOL, equal_nan=True)


def test_streamed_kernels_read_strided_views(cuda):
    """The fold patches reach the kernels as a transposed view [B, nv, K] of
    [nv, B, K]: the same counts as a contiguous copy, and no copy is made."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    Xv = torch.randn((300, 16, 40), generator=gen, device=cuda)
    Z = torch.randn((16, 40, 300), generator=gen, device=cuda)
    inv = torch.randn((16, 40, 40), generator=gen, device=cuda)
    view = Xv.permute(1, 0, 2)
    assert not view.is_contiguous()
    for got, ref in ((HM.streamed_acc_from_factors(view, Z),
                      HM.streamed_acc_from_factors(view.contiguous(), Z)),
                     (HM.streamed_acc_from_inv(view, inv, Z),
                      HM.streamed_acc_from_inv(view.contiguous(), inv, Z)),
                     (HM.streamed_pairwise_acc(view, Xv[:, 0]),
                      HM.streamed_pairwise_acc(view.contiguous(), Xv[:, 0].contiguous()))):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _ints(gen, *shape):
    return torch.randint(-3, 4, shape, generator=gen, device=gen.device).float()


def _like(x, pad):
    """x's values in a [B, K, n] view whose rows are padded by ``pad`` floats."""
    b, k, n = x.shape
    return torch.empty((b, k, n + pad), device=x.device)[..., :n].copy_(x)


@pytest.mark.parametrize("kd", [31, 32, 33, 750])
def test_streamed_kernels_every_copy_width(cuda, kd):
    """The kernels pick 16-, 8- or 4-byte copies per operand and vertex from
    its strides and base address, and a [o][k] or [k][o] stage layout from
    its unit-stride axis: every choice gives the plain version's counts on
    integer inputs.  Xv_b's vertex stride kd x 4 bytes is 16-byte aligned at
    kd = 32, 8-byte on odd vertices at 750, 4-byte at 31 and 33."""
    gen = torch.Generator(device=cuda).manual_seed(kd)
    b, nv = 4, 257
    Xv_b = _ints(gen, nv, b, kd).permute(1, 0, 2)
    Z = _ints(gen, b, kd, nv)  # rows of 1028 bytes: 4-byte copies
    inv = _ints(gen, b, kd, kd)
    zs = {"unpadded": Z, "padded": HM.padded_empty(b, kd, nv, cuda).copy_(Z),
          "rows_8_byte": _like(Z, 1), "k_contiguous": Z.mT.contiguous().mT,
          "every_other": torch.empty((b, kd, 2 * nv), device=cuda)[..., ::2].copy_(Z)}
    ref = HM.streamed_acc_from_factors_plain(Xv_b, Z)
    for layout, z in zs.items():
        for x in (Xv_b, Xv_b.contiguous()):
            assert torch.equal(HM.streamed_acc_from_factors(x, z), ref), layout
    ref = HM.streamed_acc_from_inv_plain(Xv_b, inv, Z)
    for layout in ("unpadded", "padded", "rows_8_byte", "k_contiguous", "every_other"):
        assert torch.equal(HM.streamed_acc_from_inv(Xv_b, inv, zs[layout]), ref), layout
    # preds rows of kd x 4 bytes; unit latents shared by every vertex (batch stride 0)
    preds, latents = _streamed_inputs("streamed_pairwise_acc", "integer", b, nv, kd, cuda)
    assert torch.equal(HM.streamed_pairwise_acc(preds, latents),
                       HM.streamed_pairwise_acc_plain(preds, latents))


def test_streamed_counts_equal_on_padded_and_unpadded_z(cuda):
    """The port pads the rows of Z and U (HM.padded_empty) so the kernels copy
    them 16 bytes at a time; the counts are those of the unpadded form, bit
    for bit, on Gaussian inputs too (the same FMAs in the same order)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, nv, k = 8, 1639, 750
    Xv_b = torch.randn((nv, b, k), generator=gen, device=cuda).permute(1, 0, 2)
    Z = torch.randn((b, k, nv), generator=gen, device=cuda)
    inv = torch.randn((b, k, k), generator=gen, device=cuda) / k
    Zp = HM.padded_empty(b, k, nv, cuda).copy_(Z)
    assert Zp.stride(1) % 4 == 0 and Z.stride(1) % 4 != 0
    assert torch.equal(HM.streamed_acc_from_factors(Xv_b, Z),
                       HM.streamed_acc_from_factors(Xv_b, Zp))
    assert torch.equal(HM.streamed_acc_from_inv(Xv_b, inv, Z),
                       HM.streamed_acc_from_inv(Xv_b, inv, Zp))
    # and the Z GEMM writes the padded view's rows with the same values
    Z1, Z2 = HM.inv_times_u_on_card(inv, Z), HM.inv_times_u_on_card(inv, Zp)
    assert Z1.stride(1) % 4 == 0 and torch.equal(Z1, Z2)


def test_streamed_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros((2, 5, 3), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        HM.streamed_acc_from_factors(x.double(), torch.zeros((2, 3, 5), device=cuda).double())
    with pytest.raises(TypeError, match="float32"):
        HM.streamed_pairwise_acc(x, torch.zeros((5, 3), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match=r"Z \[B, K, nv\]"):
        HM.streamed_acc_from_factors(x, torch.zeros((2, 5, 3), device=cuda))
    with pytest.raises(ValueError, match="several devices"):
        HM.streamed_acc_from_inv(x, torch.zeros((2, 3, 3)), torch.zeros((2, 3, 5), device=cuda))


@pytest.mark.parametrize("alpha", [1e2, 1e7])
@pytest.mark.parametrize("pb", [102, 103])
def test_chol_inv_panel_kernel_at_whole_brain_shapes(cuda, pb, alpha):
    """[6, PB, PB]: the whole-brain CV's Schur base blocks (6 alphas; PB 102
    and 103, neither a multiple of 4), grams of 8192 rows plus alpha I."""
    gen = torch.Generator(device=cuda).manual_seed(pb)
    X = torch.randn((6, 8192, pb), generator=gen, device=cuda)
    A = X.mT @ X + alpha * torch.eye(pb, device=cuda)
    before = H.launches
    got = H.chol_inv_panel(A)
    assert H.launches == before + 1
    ref = H.chol_inv_panel_plain(A)
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel <= REL_TOL, rel
    assert torch.all(torch.triu(got, 1) == 0)


def test_whole_brain_cv_on_schur_pallas_selects_as_the_strict_path(cuda):
    """ridge_cv_dual at n = 8192 on the card: the "schur-pallas" selection
    picks the strict Cholesky path's alpha, with 64 panel launches a fold
    (n_tr = 6553|6554 halves six times to base blocks of PB 102|103)."""
    from multimodal_decoding_tpu_torch.ops.ridge import ridge_cv_dual

    alphas = [1e2, 1e3, 1e4, 1e5, 1e6, 1e7]
    gen = torch.Generator(device=cuda).manual_seed(0)
    Y = torch.randn((8192, 128), generator=gen, device=cuda)
    G = torch.randn((128, 2048), generator=gen, device=cuda) / 128 ** 0.5
    X = Y @ G + 2.0 * torch.randn((8192, 2048), generator=gen, device=cuda)
    K = X @ X.T
    strict_idx, strict_scores, _ = ridge_cv_dual(K, Y, alphas, device=cuda)
    H.reset_launches()
    idx, scores, _ = ridge_cv_dual(K, Y, alphas, cv_solver="schur-pallas", device=cuda)
    assert H.launches == 5 * 64
    assert idx == strict_idx
    assert abs(scores - strict_scores).max() <= 1e-4


def test_streamed_gram_and_query_kernels_on_the_card(cuda):
    """The pinned, double-buffered upload of host column blocks (a ragged last
    block, more blocks than buffers) gives the products of the whole arrays."""
    import numpy as np

    from multimodal_decoding_tpu_torch.ops.ridge import streamed_kernels

    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 5 * 256 + 77), dtype=np.float32)
    Xq = rng.standard_normal((7, X.shape[1]), dtype=np.float32)
    K, (Kq,) = streamed_kernels(X, (Xq,), block_cols=256, device=cuda)
    x64 = X.astype(np.float64)
    for got, ref in ((K, x64 @ x64.T), (Kq, Xq.astype(np.float64) @ x64.T)):
        assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() <= 1e-5


# ---------------------------------------------------------------------------
# The tensor-core variants ("default", "high") and the bf16 first operand
# ---------------------------------------------------------------------------


def _precision_inputs(name, kind, b, nv, k, device):
    """Inputs for the precision variants.  Integer inputs lie in -16..16,
    which bf16 holds exactly, so every variant counts exactly: latent rows
    have 16, 4 or 1 entries of +-1 (unit rows of +-1/4, +-1/2, +-1), and the
    inverses are signed diagonals of +-1, +-2, so Z = inv U stays in bf16's
    integers."""
    gen = torch.Generator(device=device).manual_seed(b * 7919 + nv * 31 + k)

    def draw(*shape):
        if kind == "integer":
            return torch.randint(-16, 17, shape, generator=gen, device=device).float()
        return torch.randn(shape, generator=gen, device=device)

    if name == "streamed_pairwise_acc":
        if kind == "integer":
            n_on = 16 if k >= 16 else (4 if k >= 4 else 1)
            top = torch.rand((nv, k), generator=gen, device=device).topk(n_on, dim=-1).indices
            signs = torch.randint(0, 2, top.shape, generator=gen, device=device).float() * 2 - 1
            latents = torch.zeros((nv, k), device=device).scatter_(1, top, signs)
        else:
            latents = draw(nv, k)
        return draw(b, nv, k), latents
    Xv_b = draw(nv, b, k).permute(1, 0, 2)  # the main path's transposed view
    Z = HM.padded_empty(b, k, nv, device).copy_(draw(b, k, nv))
    if name == "streamed_acc_from_inv":
        if kind == "integer":
            vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=device)
            inv = torch.diag_embed(vals[torch.randint(0, 4, (b, k), generator=gen,
                                                      device=device)])
        else:
            inv = draw(b, k, k) / k
        return Xv_b, inv, Z
    return Xv_b, Z


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("precision", ["highest", "default", "high"])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("b,nv,k", [
    (1, 1, 1), (2, 7, 5), (2, 129, 31), (3, 257, 33), (2, 256, 32),
    (4, 257, 750), (128, 1639, 750), (128, 1639, 1024)])
@pytest.mark.parametrize("name", HM.KERNELS)
def test_streamed_variants_match_plain(cuda, name, b, nv, k, kind, precision, a_dtype):
    """Each variant against its plain version at its precision: counts equal
    on integer inputs; on Gaussian ones within ACC_TOL, or two flipped
    near-ties where one flip, 1/(nv^2 - nv), exceeds it (the tensor cores sum
    in another order than cuBLAS)."""
    args = list(_precision_inputs(name, kind, b, nv, k, cuda))
    args[0] = args[0].to(a_dtype)
    before = dict(HM.launches_by_precision[name])
    got = getattr(HM, name)(*args, precision=precision)
    torch.cuda.synchronize()
    after = HM.launches_by_precision[name]
    assert after[precision] == before[precision] + 1
    assert all(after[p] == before[p] for p in after if p != precision)
    ref = getattr(HM, name + "_plain")(*args, precision=precision)
    if kind == "integer":
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    else:
        tol = max(ACC_TOL, 2.0 / max(nv * nv - nv, 1))
        torch.testing.assert_close(got, ref, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("kd", [31, 32, 33, 750])
def test_bf16_first_operand_every_load_width(cuda, kd):
    """A bf16 first operand whose vertex stride is kd x 2 bytes (Xv_b): the
    SIMT core (highest) loads it 16, 8, 4 or 2 bytes a thread by its
    vertex's alignment, the tensor-core core (default, high) by tensor map,
    from the wrapper's padded copy where the strides do not allow it.  Every
    width, and a copy made where its k axis is not contiguous, counts as the
    float32 operand holding the same values."""
    gen = torch.Generator(device=cuda).manual_seed(kd)
    b, nv = 8, 257
    Xv_b = _ints(gen, nv, b, kd).permute(1, 0, 2).bfloat16()
    Z = HM.padded_empty(b, kd, nv, cuda).copy_(_ints(gen, b, kd, nv))
    for precision in ("highest", "default", "high"):
        ref = HM.streamed_acc_from_factors(Xv_b.float(), Z, precision)
        for x in (Xv_b, Xv_b.contiguous(), Xv_b.mT.contiguous().mT):
            assert torch.equal(HM.streamed_acc_from_factors(x, Z, precision), ref), precision


def test_store_gemm_rounds_as_the_tpu_dot(cuda):
    """streamed_acc_from_inv's Z GEMM at "default" is the product of the
    bf16-rounded inv and U with float32 sums, written rounded once to bf16
    (its one plane); at "high" of the bf16 x 3 passes, written as hi and lo
    = bf16(Z - hi)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, k, nv = 4, 750, 300
    inv = torch.randn((b, k, k), generator=gen, device=cuda) / k
    U = HM.padded_empty(b, k, nv, cuda).copy_(torch.randn((b, k, nv), generator=gen,
                                                          device=cuda))
    scale = (inv.abs() @ U.abs()).max()
    sums = 4 * k * 2.0 ** -24 * float(scale)  # two float32 sums of the same products
    for precision in ("default", "high"):
        Z = HM.inv_times_u_on_card(inv, U, precision)
        assert Z.dtype == torch.bfloat16 and Z.shape == (HM.PLANES[precision], b, k, nv)
        assert Z.stride(2) % 8 == 0
        ref = PR.matmul(inv, U, precision)
        hi = Z[0].to(torch.float32)
        # one rounding to bf16: within half a bf16 ulp (2^-9 relative) of the sum
        assert bool(((hi - ref).abs() <= 2.0 ** -8 * ref.abs() + sums).all()), precision
        if precision == "high":
            assert torch.equal(Z[1].to(torch.float32), PR.round_bf16(Z[1].to(torch.float32)))
            both = hi + Z[1].to(torch.float32)
            assert float((both - ref).abs().max()) <= 2.0 ** -16 * float(scale) + sums


@pytest.mark.parametrize("a_shape,b_shape", [
    ((64, 48), (48, 16)), ((3, 64, 48), (48, 16)), ((64, 48), (3, 48, 16)),
    ((3, 64, 48), (3, 48, 16)), ((2, 1, 64, 48), (3, 48, 16))])
def test_precision_matmul_broadcasts_through_bf16_gemms(cuda, a_shape, b_shape):
    """Rounded products take cuBLAS's bf16 GEMM with float32 output at every
    broadcast shape: torch.matmul's shape, exact products, float32 sums, and
    TF32 still off."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn(a_shape, generator=gen, device=cuda)
    b = torch.randn(b_shape, generator=gen, device=cuda)
    out = PR.matmul(a, b, "default")
    assert not torch.backends.cuda.matmul.allow_tf32
    ref = PR.round_bf16(a).double() @ PR.round_bf16(b).double()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float((out.double() - ref).abs().max()) <= 2 * 48 * 2.0 ** -24 * float(
        (a.abs() @ b.abs()).max())

# ---------------------------------------------------------------------------
# The tensor-core core's routes and edges (wgmma on bf16 planes)
# ---------------------------------------------------------------------------


def _edge_first(name, x, layout):
    """The first operand in one of the layouts the tensor-core core takes: a
    float32 one (rounded into planes, by tensor map), a bf16 Xv_b in the
    engine's padded rows (by tensor map) or its unpadded transposed view
    (vertex strides of kd x 2 bytes: the wrapper reads a padded copy)."""
    if layout == "float32":
        return x
    if layout == "bfloat16_padded" and name != "streamed_pairwise_acc":
        return HM.padded_copy(x.permute(1, 0, 2), torch.bfloat16).permute(1, 0, 2)
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("layout", ["float32", "bfloat16_padded", "bfloat16_view"])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("nv", [1, 64, 65, 129])
@pytest.mark.parametrize("name,kd", [(name, kd) for name in HM.KERNELS for kd in (16, 17, 750)]
                         + [("streamed_pairwise_acc", 1024)])
def test_tensor_core_edges_match_plain(cuda, name, kd, nv, kind, layout):
    """nv of one row or column tile and one past it, depths below, at and
    past a 64-deep stage, 5 vertices (vertex strides of 1500 or 34 bytes
    in the unpadded view: even and odd vertices off 16-byte alignment), at
    default and high: counts equal on integer inputs, Gaussian within
    ACC_TOL or two flipped near-ties."""
    args = list(_precision_inputs(name, kind, 5, nv, kd, cuda))
    args[0] = _edge_first(name, args[0], layout)
    for precision in ("default", "high"):
        before = HM.launches_by_precision[name][precision]
        got = getattr(HM, name)(*args, precision=precision)
        torch.cuda.synchronize()
        assert HM.launches_by_precision[name][precision] == before + 1
        ref = getattr(HM, name + "_plain")(*args, precision=precision)
        if kind == "integer":
            torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
        else:
            tol = max(ACC_TOL, 2.0 / max(nv * nv - nv, 1))
            torch.testing.assert_close(got, ref, rtol=0, atol=tol, equal_nan=True)


def test_tensor_core_unpadded_view_counts_as_its_padded_copy(cuda):
    """The unpadded transposed view, which a tensor map cannot describe, is
    read from the wrapper's padded copy: the same counts bit for bit as the
    padded rows the engine hands over (the same planes, the same wgmma
    sums), one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    b, nv, k = 8, 300, 750
    Xv = torch.randn((nv, b, k), generator=gen, device=cuda).to(torch.bfloat16)
    Z = HM.padded_empty(b, k, nv, cuda).copy_(torch.randn((b, k, nv), generator=gen,
                                                          device=cuda))
    view = Xv.permute(1, 0, 2)
    padded = HM.padded_copy(Xv, torch.bfloat16).permute(1, 0, 2)
    assert not HM.tma_eligible(view.unsqueeze(0)) and HM.tma_eligible(padded.unsqueeze(0))
    for precision in ("default", "high"):
        before = HM.launches_by_precision["streamed_acc_from_factors"][precision]
        assert torch.equal(HM.streamed_acc_from_factors(view, Z, precision),
                           HM.streamed_acc_from_factors(padded, Z, precision))
        assert HM.launches_by_precision["streamed_acc_from_factors"][precision] == before + 2


@pytest.mark.parametrize("planes", [1, 2])
def test_bf16_planes_kernel_matches_plain(cuda, planes):
    """The rounding kernel against its plain version, bit for bit, from a
    contiguous, a transposed and a strided view, ragged columns included
    (rows of 1639 / 750 / 749 / 751 columns: tails of 3 / 2 / 1 / 3 past
    the kernel's four columns a thread)."""
    gen = torch.Generator(device=cuda).manual_seed(planes)
    x = torch.randn((3, 129, 1639), generator=gen, device=cuda) * 1e3
    for view in (x, x.mT, x[..., ::3], x[:, :1, :1], x[..., :750].contiguous(),
                 x[..., :749].contiguous(), x[..., :751]):
        got = HM.bf16_planes(view, planes)
        assert got.stride(2) % 8 == 0
        assert torch.equal(got, HM.bf16_planes_plain(view, planes))


def test_tensor_core_kernels_raise_on_an_operand_a_tensor_map_cannot_describe(cuda):
    """The padded copy is the wrapper's rule, never a try: handed an operand
    whose strides a tensor map cannot describe, the entry point refuses, and
    the call raises."""
    x = torch.zeros((1, 2, 5, 17), dtype=torch.bfloat16, device=cuda)  # rows of 34 bytes
    z = HM.padded_planes(1, 2, 17, 5, cuda).zero_()
    counts = torch.zeros((2,), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="cudaError"):
        HM._call("tc_count_launch", *HM._planes_args(x), *HM._planes_args(z), 0, 2, 5, 17,
                 counts.data_ptr(), stream)


# ---------------------------------------------------------------------------
# streamed_acc_from_factors on Z's bf16 planes (the selection path's form)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["bfloat16_padded", "bfloat16_view"])
@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("kd", [16, 17, 750])
@pytest.mark.parametrize("nv", [1, 64, 65, 129, 1536, 1537, 1600, 1639, 1700])
def test_factor_count_on_z_planes_matches_plain(cuda, nv, kd, precision, layout):
    """B5 with Z handed over as its planes (HM.factor_planes' form) against
    its plain version on the same planes, at every width of the last column
    tile (64: nv 1, 64, 1537, 1600; 128: 65, 1639; 192: 129, 1700; 256:
    1536), a bf16 Xv_b in the engine's padded rows and as the unpadded
    transposed view: integer counts equal, Gaussian within ACC_TOL or two
    flipped near-ties; one launch each, and the same counts as the float32
    Z they were rounded from."""
    name = "streamed_acc_from_factors"
    planes = HM.PLANES[precision]
    for kind in ("integer", "gaussian"):
        Xv_b, Z = _precision_inputs(name, kind, 3, nv, kd, cuda)
        Xv_b = _edge_first(name, Xv_b, layout)
        z_planes = HM.bf16_planes(Z, planes)
        before = HM.launches_by_precision[name][precision]
        got = HM.streamed_acc_from_factors(Xv_b, z_planes, precision)
        torch.cuda.synchronize()
        assert HM.launches_by_precision[name][precision] == before + 1
        ref = HM.streamed_acc_from_factors_plain(Xv_b, z_planes, precision)
        if kind == "integer":
            torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
        else:
            tol = max(ACC_TOL, 2.0 / max(nv * nv - nv, 1))
            torch.testing.assert_close(got, ref, rtol=0, atol=tol, equal_nan=True)
        torch.testing.assert_close(got, HM.streamed_acc_from_factors(Xv_b, Z, precision),
                                   rtol=0, atol=0, equal_nan=True)  # nv = 1: 0 / 0


def test_factor_count_refuses_z_planes_a_tensor_map_cannot_describe(cuda):
    """Z's planes must be in padded_planes' layout (rows of whole 64-column
    blocks): contiguous rows of 300 columns raise, with the shapes."""
    Xv_b = torch.zeros((2, 300, 16), dtype=torch.bfloat16, device=cuda)
    Z = torch.zeros((1, 2, 16, 300), dtype=torch.bfloat16, device=cuda)
    assert not HM.planes_eligible(Z)
    with pytest.raises(ValueError, match=r"\(1, 2, 16, 300\)"):
        HM.streamed_acc_from_factors(Xv_b, Z, "default")


def test_factor_planes_on_the_card_are_the_z_gemm(cuda):
    """factor_planes on the card is inv_times_u_on_card, B4's Z GEMM: the
    same planes bit for bit, and not a launch of any streamed kernel."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, k, nv = 3, 750, 300
    inv = torch.randn((b, k, k), generator=gen, device=cuda) / k
    U = HM.padded_empty(b, k, nv, cuda).copy_(torch.randn((b, k, nv), generator=gen,
                                                          device=cuda))
    for precision in ("default", "high"):
        before = {n: dict(v) for n, v in HM.launches_by_precision.items()}
        Z = HM.factor_planes(inv, U, precision)
        assert HM.launches_by_precision == before
        assert HM.planes_eligible(Z) and Z.shape == (HM.PLANES[precision], b, k, nv)
        assert torch.equal(Z, HM.inv_times_u_on_card(inv, U, precision))


def test_fused_pallas_equals_fused_inv_on_a_gate_block(cuda):
    """One block of the gate's shapes (N = 8192 training rows, K = 750, 6
    alphas x 5 folds; 16 vertices) with bf16 selection storage: fused-pallas
    (Z's planes from factor_planes, then B5) and fused-inv (the same Z GEMM
    inside B4's call, then the same count) select the same alphas with the
    same CV scores, bit for bit, at default and high."""
    from multimodal_decoding_tpu_torch.decoding import searchlight_engine as TE

    gen = torch.Generator(device=cuda).manual_seed(21)
    n, b, k, d = 8192, 16, 750, 64
    Y = torch.randn((n, d), generator=gen, device=cuda)
    W = torch.randn((b, d, k), generator=gen, device=cuda) * 0.02
    X = torch.einsum("nd,bdk->nbk", Y, W) + torch.randn((n, b, k), generator=gen, device=cuda)
    alphas = torch.tensor([1e2, 1e3, 1e4, 1e5, 1e6, 1e7], device=cuda)
    for precision in ("default", "high"):
        kw = dict(cv_solver="schur-pallas", cv_precision=precision, cv_dtype=torch.bfloat16)
        _, best_p, scores_p = TE.fit_block_cv(X, Y, alphas, cv_scorer="fused-pallas", **kw)
        _, best_i, scores_i = TE.fit_block_cv(X, Y, alphas, cv_scorer="fused-inv", **kw)
        assert torch.equal(best_p, best_i), precision
        assert torch.equal(scores_p, scores_i), precision
