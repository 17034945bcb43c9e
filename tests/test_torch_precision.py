"""Port parity: the reduced-precision selection path against the JAX package.

``ops/precision.py`` gives ``"default"`` (one bf16 pass) and ``"high"``
(bf16 x 3) the TPU's arithmetic on every device.  JAX on the CPU computes
every precision in float32, so the JAX side here is fed operands rounded with
ml_dtypes' bfloat16 at HIGHEST: the same arithmetic, summed in another order.

Bars, each stated where it is used:
* products: per entry, |port - JAX| <= 2 K u (|a| |b|) with u = 2^-24, the
  bound on two float32 sums of the same K exact products in any order;
* streamed counts: equal on integer inputs (|x| <= 16: bf16 holds them
  exactly and float32 sums them exactly), within 1e-6 on Gaussian ones (the
  bar of tests/test_torch_streamed_metrics.py);
* solvers: the JAX package's own bands (tests/test_solvers.py:59-60) against
  Cholesky, and ``tri_lower_inverse`` as at tests/test_solvers.py:66-75;
* selection: alpha-batched and plain sweeps equal, bf16 selection as the
  JAX package's tests/test_searchlight.py:297-332 holds it; on a graded
  signal, the port's bf16 selection picks the JAX package's alphas with the
  TPU's arithmetic (``_tpu_dots``) on all but at most one vertex in 64.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from multimodal_decoding_tpu.decoding import searchlight_engine as JE
from multimodal_decoding_tpu.ops import pallas_metrics as JP
from multimodal_decoding_tpu.ops import solvers as JS
from multimodal_decoding_tpu_torch.decoding import searchlight_engine as TE
from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM
from multimodal_decoding_tpu_torch.ops import hopper_solvers as TH
from multimodal_decoding_tpu_torch.ops import metrics as TM
from multimodal_decoding_tpu_torch.ops import precision as PR
from multimodal_decoding_tpu_torch.ops import ridge as TR
from multimodal_decoding_tpu_torch.ops import solvers as TS

HIGHEST = jax.lax.Precision.HIGHEST
U32 = 2.0 ** -24
ACC_TOL = 1e-6


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (nearest even) by ml_dtypes, as float32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _split(x: np.ndarray) -> tuple:
    hi = _bf16(x)
    return hi, _bf16(np.asarray(x, np.float32) - hi)


def _jax_product(a, b, precision):
    """The TPU's product at ``precision`` as JAX computes it at HIGHEST on
    pre-rounded operands, float32 out."""
    mm = lambda x, y: np.asarray(jnp.matmul(x, y, preferred_element_type=jnp.float32,  # noqa: E731
                                            precision=HIGHEST))
    if precision == "default":
        return mm(_bf16(a), _bf16(b))
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return mm(a_hi, b_hi) + mm(a_hi, b_lo) + mm(a_lo, b_hi)


@contextlib.contextmanager
def _tpu_dots():
    """JAX's CPU dot_general at DEFAULT and HIGH with the TPU's bf16 passes.

    XLA's CPU computes every precision in float32; inside this block each
    float32 dot_general lowers instead as the sum of HIGHEST products of its
    operands' bf16 parts (one pass at DEFAULT, hi.hi + hi.lo + lo.hi at
    HIGH), rounded to its output dtype once.  Every JAX cache is cleared on
    entry and exit, so no executable crosses the boundary.
    """
    from jax._src.interpreters import mlir
    from jax._src.lax import lax as lax_internal

    table = mlir._platform_specific_lowerings["cpu"]
    prim = lax_internal.dot_general_p
    entry = table[prim]
    bf16_precisions = (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH)

    def rule(ctx, lhs, rhs, *, precision, dimension_numbers, preferred_element_type,
             **params):
        prec = precision[0] if isinstance(precision, tuple) else precision
        if prec not in bf16_precisions or not all(
                jnp.issubdtype(a.dtype, jnp.floating) for a in ctx.avals_in):
            return entry.rule(ctx, lhs, rhs, precision=precision,
                              dimension_numbers=dimension_numbers,
                              preferred_element_type=preferred_element_type, **params)
        out_dtype = ctx.avals_out[0].dtype

        def parts(x):
            x = x.astype(jnp.float32)
            hi = x.astype(jnp.bfloat16).astype(jnp.float32)
            return hi, (x - hi).astype(jnp.bfloat16).astype(jnp.float32)

        def passes(lhs, rhs):
            dot = functools.partial(jax.lax.dot_general, dimension_numbers=dimension_numbers,
                                    precision=HIGHEST, preferred_element_type=jnp.float32)
            (l_hi, l_lo), (r_hi, r_lo) = parts(lhs), parts(rhs)
            out = dot(l_hi, r_hi)
            if prec == jax.lax.Precision.HIGH:
                out = out + dot(l_hi, r_lo) + dot(l_lo, r_hi)
            return out.astype(out_dtype)

        return mlir.lower_fun(passes, multiple_results=False)(ctx, lhs, rhs)

    jax.clear_caches()
    table[prim] = mlir.LoweringRuleEntry(rule, entry.inline)
    try:
        yield
    finally:
        table[prim] = entry
        jax.clear_caches()


# ---------------------------------------------------------------------------
# The precision helper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("shape", [((5, 7), (7, 3)), ((2, 9, 33), (2, 33, 4)),
                                   ((3, 6, 50), (50, 8))])
def test_matmul_matches_jax_on_rounded_operands(precision, shape):
    rng = np.random.RandomState(len(shape[0]) * 7 + shape[0][-1])
    a = rng.randn(*shape[0]).astype(np.float32)
    b = (rng.randn(*shape[1]) * 1e3).astype(np.float32)
    got = PR.matmul(torch.as_tensor(a), torch.as_tensor(b), precision).numpy()
    ref = _jax_product(a, b, precision)
    k = a.shape[-1]
    bound = 2 * k * U32 * (np.abs(a) @ np.abs(b)) * (3 if precision == "high" else 1)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= bound)


def test_precisions_and_dtypes():
    rng = np.random.RandomState(0)
    a = torch.as_tensor(rng.randn(6, 40).astype(np.float32))
    b = torch.as_tensor(rng.randn(40, 5).astype(np.float32))
    # highest: the float32 product, and a bf16 operand widened exactly
    assert torch.equal(PR.matmul(a, b, "highest"), a @ b)
    assert torch.equal(PR.matmul(a.bfloat16(), b, "highest"), a.bfloat16().float() @ b)
    # default on a bf16-exact operand pair is the float32 product of the pair
    ar, br = PR.round_bf16(a), PR.round_bf16(b)
    assert torch.equal(PR.matmul(ar, br, "default"), ar @ br)
    # at the same precision high is closer to float64 than default
    exact = a.double() @ b.double()
    err = {p: float((PR.matmul(a, b, p).double() - exact).abs().max())
           for p in ("default", "high", "highest")}
    assert err["highest"] <= err["high"] < err["default"]
    # jax.lax.Precision.X is the port's "x"; None is "highest"
    assert [PR.resolve(p.name.lower()) for p in (jax.lax.Precision.DEFAULT,
            jax.lax.Precision.HIGH, jax.lax.Precision.HIGHEST)] == ["default", "high", "highest"]
    assert PR.resolve(None) == "highest"
    with pytest.raises(ValueError, match="unknown precision"):
        PR.resolve("tf32")
    # bf16 output: bf16 operands only, rounded once
    out = PR.matmul(a.bfloat16(), b.bfloat16(), "default", out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="bf16 operands"):
        PR.matmul(a, b, "default", out_dtype=torch.bfloat16)
    # the shipped selection settings change no default
    assert PR.default_cv_precision("cpu") == "highest" and PR.default_cv_dtype("cpu") is None


def test_default_is_one_bf16_pass_on_the_cpu_too():
    """By design: where JAX on the CPU computes DEFAULT in float32, the port's
    "default" rounds its operands on the CPU as on the card (ROADMAP C)."""
    rng = np.random.RandomState(3)
    a = rng.randn(8, 64).astype(np.float32)
    b = rng.randn(64, 8).astype(np.float32)
    jax_cpu = np.asarray(jnp.matmul(a, b, precision=jax.lax.Precision.DEFAULT))
    port = PR.matmul(torch.as_tensor(a), torch.as_tensor(b), "default").numpy()
    np.testing.assert_allclose(jax_cpu, a @ b, rtol=1e-5, atol=1e-5)  # JAX: float32
    assert np.abs(port - jax_cpu).max() > 1e-3  # the port: one bf16 pass
    np.testing.assert_allclose(port, _jax_product(a, b, "default"), rtol=1e-5, atol=1e-5)


def test_metrics_take_precision():
    rng = np.random.RandomState(4)
    p = rng.randn(3, 20, 16).astype(np.float32)
    y = rng.randn(20, 16).astype(np.float32)
    yn = y / np.linalg.norm(y, axis=-1, keepdims=True)
    for precision in ("default", "high"):
        got = TM.pairwise_acc_scale_invariant(torch.as_tensor(p), torch.as_tensor(yn),
                                              precision).numpy()
        sim = _jax_product(p, yn.T, precision)
        # the counts of JAX's similarities, in the port's count ratio
        np.testing.assert_array_equal(got, TM.pairwise_acc_from_sim(torch.from_numpy(sim.copy())).numpy())
        dist = TM.cosine_distances(torch.as_tensor(p), torch.as_tensor(y), precision).numpy()
        pn = p / np.linalg.norm(p, axis=-1, keepdims=True)
        ref = 1.0 - _jax_product(pn, yn.T, precision)
        assert np.abs(dist - ref).max() <= 4 * 16 * U32 * 3


# ---------------------------------------------------------------------------
# The streamed counts' plain versions at each precision (B3/B4/B5)
# ---------------------------------------------------------------------------

SHAPES = [(2, 7, 5), (3, 130, 17), (2, 300, 40)]  # (B, nv, K); nv crosses the JAX tiles


def _counts_inputs(kind, b, nv, k, seed):
    rng = np.random.RandomState(seed)

    def draw(*shape):
        if kind == "integer":
            return rng.randint(-16, 17, shape).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)

    if kind == "integer":  # rows of 16 entries +-1: unit rows of +-0.25, exact
        y = np.zeros((nv, 48), np.float32)
        for i in range(nv):
            y[i, rng.choice(48, 16, replace=False)] = rng.choice([-1.0, 1.0], 16)
        # signed diagonal inverses: Z = inv U stays an integer bf16 holds
        inv = np.stack([np.diag(rng.choice([-2.0, -1.0, 1.0, 2.0], k)) for _ in range(b)])
    else:
        y = draw(nv, 48)
        inv = draw(b, k, k) / k
    return draw(b, nv, 48), y, draw(b, nv, k), inv.astype(np.float32), draw(b, k, nv)


def _expanded(a, z, precision):
    """(A', Z') whose plain float32 product is the TPU's a @ z at
    ``precision``: rounded operands, or bf16 x 3 as three stacked depths."""
    if precision == "default":
        return _bf16(a), _bf16(z)
    a_hi, a_lo = _split(a)
    z_hi, z_lo = _split(z)
    return (np.concatenate([a_hi, a_hi, a_lo], axis=-1),
            np.concatenate([z_hi, z_lo, z_hi], axis=-2))


def _jax_factor_counts(a, z, precision):
    """JAX's streamed_acc_from_factors (Pallas, interpret) on the expanded operands."""
    a2, z2 = _expanded(a, z, precision)
    return np.asarray(JP.streamed_acc_from_factors(a2, z2, precision=HIGHEST, interpret=True))


@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["default", "high"])
def test_plain_counts_match_the_jax_kernels(precision, shape, kind, a_dtype):
    b, nv, k = shape
    preds, y, Xv_b, inv, U = _counts_inputs(kind, b, nv, k, seed=sum(shape))
    first = (lambda x: torch.as_tensor(x).to(getattr(torch, a_dtype)))
    # the JAX side sees the first operand as the port does: rounded when bf16
    if a_dtype == "bfloat16":
        preds, Xv_b = _bf16(preds), _bf16(Xv_b)
    HM.reset_launches()

    got = HM.streamed_pairwise_acc(first(preds), torch.as_tensor(y), precision).numpy()
    y_unit = HM._unit_rows(torch.as_tensor(y)).numpy()  # the port's unit rows
    ref = _jax_factor_counts(preds, np.broadcast_to(y_unit.T, (b, 48, nv)), precision)
    if kind == "integer":  # exact unit rows: the JAX kernel itself takes the latents
        np.testing.assert_array_equal(ref, np.asarray(JP.streamed_pairwise_acc(
            preds, y, precision=HIGHEST, interpret=True)))
    _assert_counts(got, ref, kind)

    got = HM.streamed_acc_from_factors(first(Xv_b), torch.as_tensor(U), precision).numpy()
    _assert_counts(got, _jax_factor_counts(Xv_b, U, precision), kind)

    # streamed_acc_from_inv: Z = inv U at precision, then Xv_b Z at precision
    got = HM.streamed_acc_from_inv(first(Xv_b), torch.as_tensor(inv), torch.as_tensor(U),
                                   precision).numpy()
    inv2, U2 = _expanded(inv, U, precision)
    Z = np.asarray(jnp.matmul(inv2, U2, preferred_element_type=jnp.float32, precision=HIGHEST))
    _assert_counts(got, _jax_factor_counts(Xv_b, Z, precision), kind)
    if kind == "integer":
        np.testing.assert_array_equal(got, np.asarray(JP.streamed_acc_from_inv(
            Xv_b, inv, U, precision=HIGHEST, interpret=True)))
    assert HM.launches == dict.fromkeys(HM.KERNELS, 0)  # the CPU counts no launch


def _assert_counts(got, ref, kind):
    assert got.dtype == np.float32 and got.shape == ref.shape
    if kind == "integer":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ACC_TOL)


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def _gram(seed, n, k):
    X = np.random.RandomState(seed).randn(n, k).astype(np.float32)
    return (X.T @ X).astype(np.float32)


@pytest.mark.parametrize("alpha", [1e-1, 1e2, 1e5])
def test_solver_methods_within_the_jax_bands(alpha):
    """tests/test_solvers.py:49-63 on the port: each method against its own
    Cholesky solve within the JAX band, and against the JAX method."""
    G = _gram(0, 600, 64)
    B = np.random.RandomState(1).randn(1, 64, 9).astype(np.float32)
    A = (G + alpha * np.eye(64, dtype=np.float32))[None]
    ref = TS.spd_solve(torch.as_tensor(A), torch.as_tensor(B), method="cholesky").numpy()
    scale = np.abs(ref).max()
    for method, tol in (("schur-cb", 5e-5), ("tri-inv", 5e-5),
                        ("schur-cb16", 2e-2), ("schur-cb16-ns", 2e-4)):
        got = TS.spd_solve(torch.as_tensor(A), torch.as_tensor(B), method=method).numpy()
        jax_got = np.asarray(JS.spd_solve(jnp.asarray(A), jnp.asarray(B), method=method,
                                          precision=HIGHEST))
        assert np.abs(got - ref).max() / scale < tol, (method, alpha)
        assert np.abs(jax_got - ref).max() / scale < tol, (method, alpha)
        assert np.abs(got - jax_got).max() / scale < tol, (method, alpha)


def test_apply_dtype_and_precision_match_jax():
    """apply_dtype narrows the inverse and the right-hand side of the apply
    GEMM; at "default" every recursion product rounds its operands."""
    G = _gram(2, 800, 160)
    A = (G + 1e3 * np.eye(160, dtype=np.float32))[None]
    B = np.random.RandomState(3).randn(1, 160, 7).astype(np.float32)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    inv = TS.spd_inverse(At, method="schur-cb").numpy()
    got = TS.spd_solve(At, Bt, method="schur-cb", apply_dtype=torch.bfloat16).numpy()
    ref = _jax_product(inv, B, "default")  # bf16 inverse and rhs, float32 sums
    assert np.abs(got - ref).max() <= 2 * 160 * U32 * (np.abs(_bf16(inv)) @ np.abs(_bf16(B))).max()
    # the recursion at "default": within bf16 grade of the float32 inverse
    for method in ("schur", "schur-cb", "tri-inv"):
        d = TS.spd_inverse(At, method=method, precision="default").numpy()
        assert np.abs(d - inv).max() / np.abs(inv).max() < 2e-2, method
    # the blocked driver's GEMMs take precision too
    d = TH.blocked_spd_inverse(At, precision="default").numpy()
    assert np.abs(d - inv).max() / np.abs(inv).max() < 2e-2
    np.testing.assert_allclose(TH.blocked_spd_inverse(At).numpy(), inv, rtol=0,
                               atol=1e-4 * np.abs(inv).max())


def test_tri_lower_inverse_blocked():
    """tests/test_solvers.py:66-75 on the port, and equal to JAX's within float32."""
    rng = np.random.RandomState(0)
    X = rng.randn(2, 450, 150).astype(np.float32)
    A = (np.einsum("bnk,bnl->bkl", X, X) + 150 * np.eye(150)).astype(np.float32)
    L = np.linalg.cholesky(A).astype(np.float32)
    L_inv = TS.tri_lower_inverse(torch.as_tensor(L), base=48).numpy()
    eye = np.einsum("bij,bjk->bik", L, L_inv)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(150), eye.shape), atol=2e-3)
    assert np.allclose(np.triu(L_inv, 1), 0.0, atol=1e-6)  # strictly lower-triangular
    ref = np.asarray(JS.tri_lower_inverse(jnp.asarray(L), base=48, precision=HIGHEST))
    np.testing.assert_allclose(L_inv, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    via = TS.spd_inverse_via_tri(torch.as_tensor(A), base=48).numpy()
    np.testing.assert_allclose(via, np.linalg.inv(A.astype(np.float64)), rtol=0,
                               atol=5e-5 * np.abs(via).max())


# ---------------------------------------------------------------------------
# The selection sweep
# ---------------------------------------------------------------------------


def test_cv_alpha_batch_and_unroll_parity():
    """tests/test_searchlight.py:415-431 on the port: the chunked alpha-batched
    inverse gives the per-alpha sweep's alphas and scores exactly, and those
    are the JAX package's (the JAX package's unrolled sweep is the port's
    plain one: ROADMAP standing entry 17)."""
    rng = np.random.RandomState(0)
    n, k, d, v = 60, 8, 6, 12
    Ytr = rng.randn(n, d).astype(np.float32)
    Xtr = (Ytr @ rng.randn(d, v) + rng.randn(n, v)).astype(np.float32)
    adj = np.stack([rng.choice(v, size=k, replace=False) for _ in range(v)]).astype(np.int32)
    alphas = np.asarray([1.0, 10.0, 100.0, 1000.0], dtype=np.float32)
    patches = TE.gather_patches(torch.as_tensor(Xtr), torch.as_tensor(adj))
    Y, al = torch.as_tensor(Ytr), torch.as_tensor(alphas)
    _, b0, s0 = TE.fit_block_cv(patches, Y, al, 3, cv_solver="schur-cb")
    for kw in ({"cv_alpha_batch": 2}, {"cv_alpha_batch": 4}, {"cv_alpha_batch": True}):
        _, b1, s1 = TE.fit_block_cv(patches, Y, al, 3, cv_solver="schur-cb", **kw)
        assert torch.equal(b0, b1), kw
        assert torch.equal(s0, s1), kw
    _, jb, js = JE.fit_block_cv(JE.gather_patches(jnp.asarray(Xtr), jnp.asarray(adj)), Ytr,
                                jnp.asarray(alphas), 3, cv_solver="schur-cb")
    np.testing.assert_array_equal(b0.numpy(), np.asarray(jb))
    np.testing.assert_allclose(s0.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_cv_bf16_selection_path():
    """tests/test_searchlight.py:297-332 on the port: bf16 selection at
    "default" picks the strict path's alpha on >= 95% of the vertices, whose
    final scores are then bitwise the strict path's (the refit never touches
    the bf16 copies), and the JAX package's bf16 selection picks the same."""
    rng = np.random.RandomState(0)
    n_train, k, d, v = 160, 24, 16, 48
    Ytr = rng.randn(n_train, d).astype(np.float32)
    Yte = rng.randn(10, d).astype(np.float32)
    Yim = rng.randn(3, d).astype(np.float32)
    W = rng.randn(d, v).astype(np.float32) * 0.3
    X_all = np.concatenate([Ytr, Yte, Yim]) @ W
    X_all += rng.randn(*X_all.shape).astype(np.float32)
    adj = np.stack([rng.choice(v, size=k, replace=False) for _ in range(v)]).astype(np.int32)
    stim = np.array(["caption"] * 5 + ["image"] * 5)
    alphas = np.asarray([1e0, 1e2, 1e4], dtype=np.float32)

    t = [torch.as_tensor(a) for a in (X_all, Ytr, Yte, Yim)]
    kw = dict(layout=TE.TestLayout.from_stim_types(stim), n_train=n_train, n_test=10)
    strict = TE.searchlight_block_cv(*t, torch.as_tensor(adj), None, torch.as_tensor(alphas),
                                     cv_scorer="strict", **kw)
    fast = TE.searchlight_block_cv(*t, torch.as_tensor(adj), None, torch.as_tensor(alphas),
                                   cv_precision="default", cv_solver="schur-cb",
                                   cv_dtype=torch.bfloat16, **kw)
    agree = (fast["best_alpha"] == strict["best_alpha"]).numpy()
    assert agree.mean() >= 0.95, agree.mean()
    for m in strict:
        if m != "best_alpha":
            np.testing.assert_array_equal(fast[m].numpy()[agree], strict[m].numpy()[agree],
                                          err_msg=m)
    jkw = dict(layout=JE.TestLayout.from_stim_types(stim), n_train=n_train, n_test=10)
    jfast = JE.searchlight_block_cv(X_all, Ytr, Yte, Yim, adj, None, alphas,
                                    cv_precision=jax.lax.Precision.DEFAULT,
                                    cv_solver="schur-cb", cv_dtype=jnp.bfloat16, **jkw)
    np.testing.assert_array_equal(fast["best_alpha"].numpy(), np.asarray(jfast["best_alpha"]))


def test_tpu_dots_round_like_the_port():
    """Inside _tpu_dots, JAX's DEFAULT and HIGH products are the port's up to
    float32 summation order; outside it JAX's CPU computes float32 again."""
    rng = np.random.RandomState(11)
    a, b = rng.randn(3, 40, 64).astype(np.float32), rng.randn(3, 64, 24).astype(np.float32)
    with _tpu_dots():
        got = {p: np.asarray(jnp.einsum("bik,bkj->bij", a, b, precision=jp,
                                        preferred_element_type=jnp.float32))
               for p, jp in (("default", jax.lax.Precision.DEFAULT),
                             ("high", jax.lax.Precision.HIGH))}
    for p, v in got.items():
        ref = PR.matmul(torch.as_tensor(a), torch.as_tensor(b), p).numpy()
        bar = 2 * 64 * U32 * (np.abs(a) @ np.abs(b))
        assert (np.abs(v - ref) <= bar).all(), p
    outside = np.asarray(jnp.matmul(a, b, precision=jax.lax.Precision.DEFAULT))
    np.testing.assert_allclose(outside, a @ b, rtol=1e-5, atol=1e-4)
    assert np.abs(outside - got["default"]).max() > 1e-3  # the bf16 pass is gone again


def test_cv_bf16_selection_on_a_graded_signal(capsys):
    """The gate's kind of problem at small size: the planted signal's scale
    rises over the vertices (1e-2 to 10^-0.5) and neighbourhoods are
    contiguous, so the selected alphas spread over the grid and many
    vertices sit near a tie.  Both packages select with bf16 storage at
    DEFAULT, JAX with the TPU's arithmetic (_tpu_dots): the port picks the
    JAX package's alphas on all but at most one of the 64 vertices, and the
    two agree with their strict paths alike, however far below the JAX
    package's 0.95 bar (set on a strong signal) that lands."""
    rng = np.random.RandomState(0)
    n_train, k, d, v = 160, 24, 16, 64
    Ytr = rng.randn(n_train, d).astype(np.float32)
    Yte = rng.randn(10, d).astype(np.float32)
    Yim = rng.randn(3, d).astype(np.float32)
    W = rng.randn(d, v).astype(np.float32) * (10.0 ** np.linspace(-2, -0.5, v)).astype(
        np.float32)
    X_all = np.concatenate([Ytr, Yte, Yim]) @ W
    X_all += rng.randn(*X_all.shape).astype(np.float32)
    adj = np.stack([np.sort(np.argsort(np.abs(np.arange(v) - i), kind="stable")[:k])
                    for i in range(v)]).astype(np.int32)
    stim = np.array(["caption"] * 5 + ["image"] * 5)
    alphas = np.asarray([1e0, 1e1, 1e2, 1e3, 1e4, 1e5], dtype=np.float32)

    t = [torch.as_tensor(a) for a in (X_all, Ytr, Yte, Yim, adj)]
    kw = dict(layout=TE.TestLayout.from_stim_types(stim), n_train=n_train, n_test=10)
    strict = TE.searchlight_block_cv(*t, None, torch.as_tensor(alphas), cv_scorer="strict",
                                     **kw)["best_alpha"].numpy()
    fast = TE.searchlight_block_cv(*t, None, torch.as_tensor(alphas), cv_precision="default",
                                   cv_solver="schur-cb", cv_dtype=torch.bfloat16,
                                   **kw)["best_alpha"].numpy()
    jkw = dict(layout=JE.TestLayout.from_stim_types(stim), n_train=n_train, n_test=10)
    jstrict = np.asarray(JE.searchlight_block_cv(X_all, Ytr, Yte, Yim, adj, None, alphas,
                                                 cv_scorer="strict", **jkw)["best_alpha"])
    with _tpu_dots():
        jfast = np.asarray(JE.searchlight_block_cv(
            X_all, Ytr, Yte, Yim, adj, None, alphas, cv_precision=jax.lax.Precision.DEFAULT,
            cv_solver="schur-cb", cv_dtype=jnp.bfloat16, **jkw)["best_alpha"])
    np.testing.assert_array_equal(strict, jstrict)
    assert len(np.unique(strict)) >= 4  # the alphas spread over the grid
    assert (fast != jfast).sum() <= 1, np.flatnonzero(fast != jfast)
    port, jax_own = float(np.mean(fast == strict)), float(np.mean(jfast == jstrict))
    assert abs(port - jax_own) <= 1 / v
    with capsys.disabled():
        print(f"\nbf16 selection on a graded signal: agreement with the strict path "
              f"{port:.4f} (port), {jax_own:.4f} (JAX, TPU arithmetic); alphas differ "
              f"between the packages on {int((fast != jfast).sum())} of {v} vertices")


@pytest.mark.parametrize("cv_scorer", ["pallas", "fused", "fused-pallas", "fused-inv"])
def test_bf16_selection_under_every_scorer(cv_scorer):
    """cv_dtype reaches every fold scorer: the streamed ones get bf16 first
    operands (predictions or fold patches) and float32 others, as in the JAX
    package, and select as the xla scorer does at the same settings."""
    rng = np.random.RandomState(5)
    n, k, d, v = 90, 10, 12, 16
    Y = rng.randn(n, d).astype(np.float32)
    X = (Y @ (rng.randn(d, v) * 0.4) + rng.randn(n, v)).astype(np.float32)
    adj = np.stack([rng.choice(v, size=k, replace=False) for _ in range(v)]).astype(np.int32)
    patches = TE.gather_patches(torch.as_tensor(X), torch.as_tensor(adj))
    al = torch.as_tensor([1.0, 1e2, 1e4])
    kw = dict(cv_solver="schur-cb", cv_precision="default", cv_dtype=torch.bfloat16)
    _, b_ref, _ = TE.fit_block_cv(patches, torch.as_tensor(Y), al, **kw)
    _, b, s = TE.fit_block_cv(patches, torch.as_tensor(Y), al, cv_scorer=cv_scorer, **kw)
    assert s.shape == (v, 3) and torch.isfinite(s).all()
    assert (b == b_ref).float().mean() >= 0.9


def test_whole_brain_cv_takes_the_selection_precision():
    """ridge_cv_dual's fast selection runs at cv_precision (None: the shipped
    "highest", bitwise the explicit one); at "default" it still selects the
    strict oracle's alpha on a planted signal."""
    rng = np.random.RandomState(7)
    Y = rng.randn(60, 5).astype(np.float32)
    X = (Y @ rng.randn(5, 300) + 3.0 * rng.randn(60, 300)).astype(np.float32)
    K = X @ X.T
    alphas = [1e0, 1e2, 1e4, 1e6]
    strict = TR.ridge_cv_dual(K, Y, alphas, device="cpu")
    shipped = TR.ridge_cv_dual(K, Y, alphas, cv_solver="schur-cb", device="cpu")
    highest = TR.ridge_cv_dual(K, Y, alphas, cv_solver="schur-cb", device="cpu",
                               cv_precision="highest")
    fast = TR.ridge_cv_dual(K, Y, alphas, cv_solver="schur-cb", device="cpu",
                            cv_precision="default")
    np.testing.assert_array_equal(shipped[1], highest[1])
    assert fast[0] == strict[0] == shipped[0]
    assert np.abs(fast[1] - strict[1]).max() < 0.05
