"""The searchlight runner between two flushes: nothing waits for the card.

``parallel/searchlight_runner.run_searchlight`` stages each block's inputs
through pinned host buffers with non-blocking copies on CUDA, builds the
score's index constants once a call, and brings a flush's pending maps back
in one copy.  None of that may change an output: the runner's maps are
bit-equal to the engine's block step called block by block with plain
uploads, across two flush windows and across a checkpoint and its resume
(CPU, tier-1).  The test marked ``cuda`` also counts the synchronising
operations PyTorch reports on the card, which must not grow with the number
of blocks between two flushes.  On a machine with a card:

    python -m pytest tests/test_torch_runner_syncs.py -q -m cuda --noconftest

This file imports no JAX.
"""

import warnings

import numpy as np
import pytest
import torch

from multimodal_decoding_tpu_torch.decoding import searchlight_engine as E
from multimodal_decoding_tpu_torch.parallel import searchlight_runner as R
from multimodal_decoding_tpu_torch.parallel.mesh import pad_to_multiple

N_TRAIN, N_TEST, N_IMAG, K, D, N_PERMS, BLOCK = 30, 8, 3, 5, 4, 5, 8
ALPHAS = [0.1, 1.0, 10.0]
NULL_SEED = 3
MODES = ["fixed", "cv", "radius"]  # each with nulls; radius: fixed alpha, masked patches


def _problem(n_blocks, seed=0):
    """A tiny hemisphere of ``n_blocks`` runner blocks, the last one padded."""
    v = n_blocks * BLOCK - 3
    rng = np.random.RandomState(seed)
    half = N_TEST // 2
    adjacency = np.stack([np.concatenate([[i], rng.choice(np.delete(np.arange(v), i), K - 1,
                                                          replace=False)])
                          for i in range(v)]).astype(np.int32)
    mask = rng.rand(v, K) < 0.7
    mask[:, 0] = True  # the centre stays in every ball
    return dict(
        X_train=rng.randn(N_TRAIN, v).astype(np.float32),
        X_test=rng.randn(N_TEST, v).astype(np.float32),
        X_imag=rng.randn(N_IMAG, v).astype(np.float32),
        Y_train=rng.randn(N_TRAIN, D).astype(np.float32),
        Y_test=rng.randn(N_TEST, D).astype(np.float32),
        Y_imag=rng.randn(N_IMAG, D).astype(np.float32),
        adjacency=adjacency,
        stim_types_test=np.array(["caption"] * half + ["image"] * (N_TEST - half)),
        shuffles=np.stack([np.concatenate([rng.permutation(half), half + rng.permutation(half)])
                           for _ in range(N_PERMS)]).astype(np.int32),
    ), mask


def _mode_kwargs(mode, mask):
    kw = dict(alphas_cv=ALPHAS) if mode == "cv" else dict(alpha=1.0)
    if mode == "radius":
        kw["adjacency_mask"] = mask
    return kw


def _run(problem, mask, mode, device="cpu", **kw):
    return R.run_searchlight(**problem, **_mode_kwargs(mode, mask), block_size=BLOCK,
                             null_seed=NULL_SEED, device=device, progress=False, **kw)


def _block_by_block(problem, mask, mode, device="cpu"):
    """The engine's null step on each block in turn, every input uploaded
    plainly and the score's constants built inside each step -> ``(scores,
    null_scores, best_alpha or None)`` as the runner returns them."""
    p = problem
    dev = torch.device(device)
    layout = E.TestLayout.from_stim_types(p["stim_types_test"])
    X_all = torch.as_tensor(np.concatenate([p["X_train"], p["X_test"], p["X_imag"]]),
                            device=dev)
    Y = [torch.as_tensor(p[k], device=dev) for k in ("Y_train", "Y_test", "Y_imag")]
    shuffles = torch.as_tensor(p["shuffles"], device=dev).long()
    idx_padded, v = pad_to_multiple(p["adjacency"], BLOCK)
    mask_padded = pad_to_multiple(mask, BLOCK)[0] if mode == "radius" else None
    main, null = [], []
    for b in range(len(idx_padded) // BLOCK):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        idx = torch.as_tensor(idx_padded[sl], device=dev).long()
        m = None if mask_padded is None else torch.as_tensor(mask_padded[sl], device=dev)
        der = torch.as_tensor(R.draw_imagery_derangements(NULL_SEED, b, BLOCK, N_PERMS),
                              device=dev).long()
        common = dict(layout=layout, n_train=N_TRAIN, n_test=N_TEST)
        if mode == "cv":
            out = E.searchlight_block_cv_with_null(
                X_all, *Y, idx, m, torch.as_tensor(ALPHAS, device=dev), shuffles, der,
                **common)
        else:
            out = E.searchlight_block_with_null(X_all, *Y, idx, m, 1.0, shuffles, der,
                                                **common)
        main.append({k: t.cpu().numpy() for k, t in out[0].items()})
        null.append({k: t.cpu().numpy() for k, t in out[1].items()})

    def collect(blocks):
        return {k: np.concatenate([blk[k] for blk in blocks])[:v] for k in blocks[0]}

    scores, nulls = collect(main), collect(null)
    return scores, nulls, scores.pop("best_alpha", None)


def _assert_bit_equal(got, want):
    scores, aux = got
    w_scores, w_null, w_alpha = want
    for g, w in ((scores, w_scores), (aux["null_scores"], w_null)):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if w_alpha is None:
        assert "best_alpha" not in aux
    else:
        np.testing.assert_array_equal(aux["best_alpha"], w_alpha)


@pytest.mark.parametrize("mode", MODES)
def test_two_flush_windows_match_block_by_block_steps(mode):
    problem, mask = _problem(n_blocks=10)
    assert R._flush_cadence(BLOCK, N_PERMS) == 8  # blocks 0-7, then 8-9
    _assert_bit_equal(_run(problem, mask, mode), _block_by_block(problem, mask, mode))


class Killed(Exception):
    pass


@pytest.mark.parametrize("mode", MODES)
def test_a_checkpoint_and_its_resume_match_block_by_block_steps(mode, monkeypatch, tmp_path):
    problem, mask = _problem(n_blocks=10)
    name = "searchlight_block_cv_with_null" if mode == "cv" else "searchlight_block_with_null"
    step, calls = getattr(R, name), []

    def killed_at_block_6(*a, **k):
        if len(calls) == 6:
            raise Killed
        calls.append(1)
        return step(*a, **k)

    ckpt = str(tmp_path / "sl.ckpt.npz")
    monkeypatch.setattr(R, name, killed_at_block_6)
    with pytest.raises(Killed):
        _run(problem, mask, mode, checkpoint_path=ckpt, checkpoint_every=4)
    monkeypatch.setattr(R, name, step)
    scores, aux = _run(problem, mask, mode, checkpoint_path=ckpt, checkpoint_every=4)
    assert aux["resumed_at_block"] == 4  # blocks 0-3 came from the checkpoint
    _assert_bit_equal((scores, aux), _block_by_block(problem, mask, mode))


@pytest.mark.parametrize("mode", MODES)
def test_the_score_constants_are_built_once_a_call(mode, monkeypatch):
    problem, mask = _problem(n_blocks=10)
    built = []
    real = E.score_constants

    def counting(*a, **k):
        built.append(1)
        return real(*a, **k)

    # the runner's name for score_constants, and the engine's own, which a step
    # handed no constants would call
    monkeypatch.setattr(R, "score_constants", counting)
    monkeypatch.setattr(E, "score_constants", counting)
    scores, aux = _run(problem, mask, mode)
    assert aux["n_blocks"] == 10 and len(built) == 1
    monkeypatch.undo()
    _assert_bit_equal((scores, aux), _block_by_block(problem, mask, mode))


def test_null_scoring_refuses_constants_built_without_the_shuffles():
    problem, mask = _problem(n_blocks=1)
    layout = E.TestLayout.from_stim_types(problem["stim_types_test"])
    rng = np.random.RandomState(1)
    preds = (torch.as_tensor(rng.randn(BLOCK, N_TEST, D).astype(np.float32)),
             torch.as_tensor(rng.randn(BLOCK, N_IMAG, D).astype(np.float32)))
    Y = [torch.as_tensor(problem[k]) for k in ("Y_test", "Y_imag")]
    shuffles = torch.as_tensor(problem["shuffles"]).long()
    der = torch.zeros((BLOCK, N_PERMS), dtype=torch.long)
    null = (shuffles, der, "gather")
    with pytest.raises(ValueError, match="built with the shuffles"):
        E._score_families(*preds, *Y, layout, null=null,
                          constants=E.score_constants(layout, "cpu"))
    built = E._score_families(*preds, *Y, layout, null=null,
                              constants=E.score_constants(layout, "cpu", shuffles))
    for got, want in zip(built, E._score_families(*preds, *Y, layout, null=null)):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned staging and stream synchronisation "
                    "exist only on the card")
    return torch.device("cuda")


def _synchronising_operations(fn):
    """``fn()`` and the number of synchronising operations PyTorch reported
    during it (``torch.cuda.set_sync_debug_mode("warn")``: one warning each,
    besides a one-off notice that the mode is a prototype)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_no_synchronisation_between_two_flushes_on_the_card(cuda, mode):
    assert R._flush_cadence(BLOCK, N_PERMS) == 8  # 4 and 8 blocks: one flush each
    _run(*_problem(n_blocks=2), mode, device=cuda)  # builds, handles, allocator pools
    counts = {}
    for n_blocks in (4, 8):
        problem, mask = _problem(n_blocks)
        got, counts[n_blocks] = _synchronising_operations(
            lambda: _run(problem, mask, mode, device=cuda))
        _assert_bit_equal(got, _block_by_block(problem, mask, mode, device=cuda))
    assert 0 < counts[4] == counts[8], counts  # the mode reports the flush's copy
