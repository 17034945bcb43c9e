"""Port parity: the entry block step and the multi-rank dry run (entry.py).

``entry()`` runs the CV block on ``"schur-pallas"`` (the panel kernel's
plain version on the CPU) and must match ``__graft_entry__.entry()`` (the
JAX Pallas kernel in interpret mode) within 1e-4, score maps stacked in the
same order.  ``dryrun_multichip(2)`` runs the sharded training step on a
gloo world of two processes; its whole-brain predictions must match the JAX
``multichip_training_step`` on a two-device mesh within 1e-4.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from multimodal_decoding_tpu_torch import entry as port_entry


def test_entry_matches_the_jax_entry():
    fn, args = port_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    jfn, jargs = jax_entry.entry()
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))  # same seeded draws
    ref = np.asarray(jfn(*jargs))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])  # best_alpha, first in sorted order


def test_dryrun_multichip_on_two_gloo_ranks_matches_jax(capsys):
    import jax
    from jax.sharding import Mesh

    from multimodal_decoding_tpu.parallel.distributed import multichip_training_step

    preds, scores = port_entry.dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK on 2 cpu ranks" in capsys.readouterr().out
    devices = np.asarray(jax.devices()[:2])
    ref_preds, ref_scores = multichip_training_step(Mesh(devices, ("v",)),
                                                    Mesh(devices, ("f",)))
    np.testing.assert_allclose(preds, np.asarray(ref_preds), rtol=0, atol=1e-4)
    # every score map of the JAX step, the (3b) cvtpu_* maps of bf16
    # selection storage among them
    assert sorted(scores) == sorted(ref_scores)
    assert any(m.startswith("cvtpu_") for m in scores)
    np.testing.assert_array_equal(scores["cv_best_alpha"], ref_scores["cv_best_alpha"])
    np.testing.assert_array_equal(scores["cvtpu_best_alpha"], ref_scores["cvtpu_best_alpha"])
    for m, v in scores.items():
        np.testing.assert_allclose(v, np.asarray(ref_scores[m]), rtol=0, atol=1e-4,
                                   err_msg=m)


def test_dryrun_refuses_more_gpus_than_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 GPUs, have 1"):
        port_entry.dryrun_multichip(2)
