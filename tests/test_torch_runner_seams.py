"""The runner's block-step seams.

``parallel/searchlight_runner.run_searchlight`` looks its block step up by
the name the runner module holds for it, once a call.  A step wrapped under
that name before the call therefore runs every block: the benchmark's
planted faults (``portbench/drivers/searchlight.py``'s ``FAULTS``) and
``chip_smoke.py``'s ``--fast-math`` check wrap them so, and tier-1 runs
neither.  This file imports no JAX.
"""

import numpy as np
import pytest

from multimodal_decoding_tpu_torch.parallel import searchlight_runner as R
from tests.test_torch_spans import _run_searchlight

STEPS = {"fixed-no-null": "searchlight_block", "fixed": "searchlight_block_with_null",
         "cv-no-null": "searchlight_block_cv", "cv": "searchlight_block_cv_with_null"}


def _fail(*_a, **_k):
    raise AssertionError("the runner called another mode's step")


@pytest.mark.parametrize("mode", list(STEPS))
def test_a_step_wrapped_under_its_runner_name_sees_every_block(monkeypatch, mode):
    ref_scores, ref_aux = _run_searchlight(mode)
    name, seen = STEPS[mode], []
    step = getattr(R, name)

    def recording(X_all, Y_train, Y_test, Y_imag, idx, *a, n_train, **k):
        seen.append(idx.shape[0])
        return step(X_all, Y_train, Y_test, Y_imag, idx, *a, n_train=n_train, **k)

    for other in STEPS.values():
        monkeypatch.setattr(R, other, recording if other == name else _fail)
    scores, aux = _run_searchlight(mode)
    assert aux["n_blocks"] == 4 and seen == [8] * 4  # 26 vertices in blocks of 8
    assert ("null_scores" in aux) != mode.endswith("-no-null")
    for got, ref in ((scores, ref_scores),
                     (aux.get("null_scores", {}), ref_aux.get("null_scores", {}))):
        assert got.keys() == ref.keys()
        for m in ref:
            np.testing.assert_array_equal(got[m], ref[m], err_msg=m)
