"""The port's imagery derangements are the JAX package's, bit for bit.

``utils/threefry.py`` computes ``jax.random``'s Threefry draws in numpy (no
jax import); the runner's ``draw_imagery_derangements`` uses it.  Here each
piece is held to ``jax.random`` itself, and both runners, given only
``null_seed``, write equal null scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_decoding_tpu.parallel.mesh import vertex_mesh
from multimodal_decoding_tpu.parallel.searchlight_runner import (
    run_searchlight as jax_run_searchlight,
)
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import (
    draw_imagery_derangements,
    run_searchlight as torch_run_searchlight,
)
from multimodal_decoding_tpu_torch.utils import threefry
from tests.test_torch_searchlight import _runner_problem
from tests.test_torch_searchlight_engine import ALPHAS

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 + 3, -5]


def _key_data(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.prng_key(seed), _key_data(key))
    for data in (0, 1, 99, 2**32 - 1):
        np.testing.assert_array_equal(threefry.fold_in(threefry.prng_key(seed), data),
                                      _key_data(jax.random.fold_in(key, data)))
    for num in (1, 2, 3, 8):
        np.testing.assert_array_equal(threefry.split(threefry.prng_key(seed), num),
                                      _key_data(jax.random.split(key, num)))
    np.testing.assert_array_equal(
        threefry.random_bits(threefry.prng_key(seed), (3, 5)),
        np.asarray(jax.random.bits(key, (3, 5), dtype=jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", [(128, 100), (1, 1), (7, 3), (5,), (33, 101)])
def test_imagery_draw_is_jax_randint(seed, shape):
    blocks = (0, 1, 2, 1000) if shape == (128, 100) else (0, 3)
    for b in blocks:
        ref = np.asarray(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), b),
                                            shape, 0, 2, dtype=jnp.int32))
        got = threefry.randint(threefry.fold_in(threefry.prng_key(seed), b), shape, 0, 2)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        if len(shape) == 2:
            np.testing.assert_array_equal(draw_imagery_derangements(seed, b, *shape), ref)


@pytest.mark.parametrize("lo,hi", [(0, 3), (-3, 11), (0, 1000), (0, 100000), (5, 5),
                                   (-2**31, 2**31 - 1)])
def test_randint_spans_match_jax(lo, hi):
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax.random.randint(key, (9, 11), lo, hi, dtype=jnp.int32))
    np.testing.assert_array_equal(threefry.randint(threefry.prng_key(3), (9, 11), lo, hi), ref)


@pytest.mark.parametrize("null_seed", [0, 5])
def test_runners_write_equal_nulls_from_the_seed_alone(null_seed):
    """Neither runner is handed derangements: both draw them from null_seed."""
    prob, p = _runner_problem()
    common = dict(alphas_cv=ALPHAS, shuffles=p["shuffles"], block_size=8, progress=False,
                  cv_solver="schur-cb", null_seed=null_seed)
    ref, ref_aux = jax_run_searchlight(**prob, mesh=vertex_mesh(jax.devices()[:1]),
                                       cv_precision=jax.lax.Precision.DEFAULT, **common)
    got, aux = torch_run_searchlight(**prob, device="cpu", **common)
    for m in ref:
        np.testing.assert_array_equal(got[m], ref[m], err_msg=m)
    assert sorted(aux["null_scores"]) == sorted(ref_aux["null_scores"])
    for m, v in ref_aux["null_scores"].items():
        np.testing.assert_array_equal(aux["null_scores"][m], v, err_msg=m)
