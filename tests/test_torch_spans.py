"""The program's spans and counters (``utils/profiling.py``).

Off (no ``torch.profiler`` profile recording): one shared no-op context, no
``record_function``, no CUDA event, nothing recorded.  On: the spans show in
the profiler's events with their nesting, and ``summary()`` adds up.  The
searchlight runner and the whole-brain gram give bit-equal outputs with the
profiler on and off, and their spans count what they ran; so does the
feature-extraction loop (``extraction/harness.run_extraction`` over a tiny
ImageBind), whose counters equal what its batches held.

This file imports no JAX.  The test marked ``cuda`` runs on a machine with
a card:

    python -m pytest tests/test_torch_spans.py -q -m cuda --noconftest
"""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache, decode_single
from multimodal_decoding_tpu_torch.extraction import imagebind as IB
from multimodal_decoding_tpu_torch.extraction.harness import StimuliDataset, run_extraction
from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight
from multimodal_decoding_tpu_torch.utils import profiling as P


@pytest.fixture(autouse=True)
def clean_record():
    P.reset()
    yield
    P.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _fail(*_a, **_k):
    raise AssertionError("called while no profile records")


def test_off_is_one_shared_noop(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    monkeypatch.setattr(torch.cuda, "Event", _fail)
    assert P.span("mdt.a") is P.span("mdt.b")
    with P.span("mdt.a"):
        with P.span("mdt.b"):
            P.count("mdt.bytes", 10)
    assert P.summary() == {"spans": {}, "counters": {}}


def test_spans_nest_in_the_profiler_and_add_up():
    with _cpu_profile() as prof:
        with P.span("mdt.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with P.span("mdt.inner"):
                    time.sleep(0.001)
                    P.count("mdt.bytes", 3)
    events = {e.name: e for e in prof.events() if e.name.startswith("mdt.")}
    assert set(events) == {"mdt.outer", "mdt.inner"}
    inner = [e for e in prof.events() if e.name == "mdt.inner"]
    assert len(inner) == 2 and all(e.cpu_parent.name == "mdt.outer" for e in inner)

    s = P.summary()
    outer, inner = s["spans"]["mdt.outer"], s["spans"]["mdt.inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert outer["host_s"] == pytest.approx(outer["self_host_s"] + inner["host_s"], abs=1e-9)
    assert inner["self_host_s"] == inner["host_s"] >= 0.002
    assert outer["self_host_s"] >= 0.002
    assert outer["stream_s"] is None and inner["stream_s"] is None
    assert s["counters"] == {"mdt.bytes": 6}


def test_a_span_closes_on_an_exception():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with P.span("mdt.outer"):
                with P.span("mdt.failing"):
                    raise ValueError("stage failed")
        with P.span("mdt.after"):
            pass
    s = P.summary()["spans"]
    assert s["mdt.failing"]["count"] == s["mdt.outer"]["count"] == 1
    # nothing left open: the next span is a top-level one
    assert s["mdt.after"]["self_host_s"] == s["mdt.after"]["host_s"]
    assert P._RECORD._stack() == []


def test_the_record_stays_bounded_and_reset_clears_it():
    with _cpu_profile():
        for i in range(3000):
            with P.span(f"mdt.stage{i % 3}"):
                P.count("mdt.n", 1)
    rec = P._RECORD
    assert len(rec._spans) == 3 and len(rec._pending) == 0
    s = P.summary()
    assert [s["spans"][f"mdt.stage{i}"]["count"] for i in range(3)] == [1000] * 3
    assert s["counters"]["mdt.n"] == 3000
    P.reset()
    assert P.summary() == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# The program's spans on tiny problems
# ---------------------------------------------------------------------------

N_TRAIN, N_TEST, N_IMAG, V, K, D, N_PERMS = 30, 8, 3, 26, 5, 4, 5


def _searchlight_inputs(seed=0):
    rng = np.random.RandomState(seed)
    half = N_TEST // 2
    shuffles = np.stack([np.concatenate([rng.permutation(half), half + rng.permutation(half)])
                         for _ in range(N_PERMS)]).astype(np.int32)
    adjacency = np.stack([np.concatenate([[v], rng.choice(np.delete(np.arange(V), v), K - 1,
                                                          replace=False)])
                          for v in range(V)]).astype(np.int32)
    return dict(
        X_train=rng.randn(N_TRAIN, V).astype(np.float32),
        X_test=rng.randn(N_TEST, V).astype(np.float32),
        X_imag=rng.randn(N_IMAG, V).astype(np.float32),
        Y_train=rng.randn(N_TRAIN, D).astype(np.float32),
        Y_test=rng.randn(N_TEST, D).astype(np.float32),
        Y_imag=rng.randn(N_IMAG, D).astype(np.float32),
        adjacency=adjacency,
        stim_types_test=np.array(["caption"] * half + ["image"] * (N_TEST - half)),
        shuffles=shuffles,
    )


def _run_searchlight(mode, device="cpu", block_size=8):
    """``mode``: "cv" or "fixed", with nulls; "cv-no-null" or "fixed-no-null"
    without (``shuffles=None``)."""
    kw = _searchlight_inputs()
    if mode.endswith("-no-null"):
        kw["shuffles"] = None
    cv = dict(alphas_cv=[0.1, 1.0, 10.0]) if mode.startswith("cv") else dict(alpha=1.0)
    return run_searchlight(**kw, **cv, block_size=block_size, device=device, progress=False)


def _assert_equal_outputs(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", ["cv", "fixed", "cv-no-null", "fixed-no-null"])
def test_searchlight_is_bit_equal_with_spans_on(mode):
    off_scores, off_aux = _run_searchlight(mode)
    assert P.summary()["spans"] == {}
    with _cpu_profile():
        on_scores, on_aux = _run_searchlight(mode)
    _assert_equal_outputs(off_scores, on_scores)
    if mode.endswith("-no-null"):
        assert "null_scores" not in on_aux
    else:
        _assert_equal_outputs(off_aux["null_scores"], on_aux["null_scores"])
    if mode.startswith("cv"):
        np.testing.assert_array_equal(off_aux["best_alpha"], on_aux["best_alpha"])

    spans = P.summary()["spans"]
    n_blocks = on_aux["n_blocks"]
    assert n_blocks == 4  # 26 vertices padded to blocks of 8
    for name in ("mdt.runner.block", "mdt.runner.upload", "mdt.engine.step",
                 "mdt.engine.gather", "mdt.engine.fit", "mdt.engine.solve",
                 "mdt.engine.score"):
        assert spans[name]["count"] == n_blocks, name
    assert spans.get("mdt.engine.select", {}).get("count", 0) == (
        n_blocks if mode.startswith("cv") else 0)
    # the last block hosts every output still on the device
    assert spans["mdt.runner.flush"]["count"] == 1
    block, step = spans["mdt.runner.block"], spans["mdt.engine.step"]
    assert block["host_s"] >= step["host_s"] + spans["mdt.runner.upload"]["host_s"]
    assert all(s["stream_s"] is None for s in spans.values())


def test_searchlight_flushes_on_its_cadence_and_last_block():
    with _cpu_profile():
        _, aux = _run_searchlight("fixed", block_size=2)  # 13 blocks, a flush every 8
    spans = P.summary()["spans"]
    assert spans["mdt.runner.block"]["count"] == aux["n_blocks"] == 13
    assert spans["mdt.runner.flush"]["count"] == 2


def _whole_brain_inputs(seed=1, n_features=40_000):
    rng = np.random.RandomState(seed)
    X = [rng.randn(n, n_features).astype(np.float32) for n in (N_TRAIN, N_TEST, N_IMAG)]
    Y = [rng.randn(n, D).astype(np.float32) for n in (N_TRAIN, N_TEST, N_IMAG)]
    return X, Y


def _decode(X, Y):
    cache = GramCache(*X, device="cpu")
    timings = {}
    out = decode_single(*X, *Y, alphas=[0.1, 10.0, 1e3], n_splits=3, gram_cache=cache,
                        device="cpu", timings=timings)
    return cache, out, timings


def test_gram_and_decode_are_bit_equal_with_spans_on():
    X, Y = _whole_brain_inputs()
    cache_off, out_off, _ = _decode(X, Y)
    with _cpu_profile():
        cache_on, out_on, timings = _decode(X, Y)
    for a, b in zip((cache_off.K, cache_off.K_test, cache_off.K_imag),
                    (cache_on.K, cache_on.K_test, cache_on.K_imag)):
        assert torch.equal(a, b)
    assert out_off[0] == out_on[0]
    for a, b in zip(out_off[1:4], out_on[1:4]):
        np.testing.assert_array_equal(a, b)

    s = P.summary()
    spans = s["spans"]
    n_blocks = -(-X[0].shape[1] // 16384)
    assert spans["mdt.gram.products"]["count"] == n_blocks == 3
    assert spans["mdt.gram.build"]["count"] == 1
    # the CPU's column blocks are views: nothing staged, nothing sent
    assert "mdt.gram.h2d" not in spans and "mdt.gram.stage" not in spans
    assert "mdt.gram.h2d_bytes" not in s["counters"]
    assert spans["mdt.ridge.select"]["count"] == spans["mdt.ridge.refit"]["count"] == 1
    assert spans["mdt.gram.build"]["host_s"] <= cache_on.gram_seconds
    assert spans["mdt.ridge.select"]["host_s"] <= timings["cv_s"]


# ---------------------------------------------------------------------------
# The extraction loop over a tiny ImageBind
# ---------------------------------------------------------------------------

IB_TINY = IB.ImageBindConfig(
    vision_embed_dim=16, vision_layers=2, vision_heads=2, text_embed_dim=12, text_layers=2,
    text_heads=2, out_embed_dim=8, image_size=28, patch_size=14, n_frames=2,
    context_length=10, vocab_size=49408)
# unequal sizes, both orientations; the last caption is cut to the context
IMAGE_SIZES = [(45, 31), (30, 40), (64, 48), (48, 64), (33, 33)]
CAPTIONS = ["a dog runs", "blue sky", "x", "two cats on a mat", "a b c d e f g h i j k l"]
BATCH = 2


def _words(texts):
    return [[(sum(map(ord, w)) % 60) + 1 for w in t.split()] for t in texts]


def _extraction_dataset(root) -> StimuliDataset:
    """JPEGs of ``IMAGE_SIZES`` under ``root``, ids 101, 102, ..."""
    from PIL import Image

    rng = np.random.RandomState(4)
    paths = {}
    for i, (w, h) in enumerate(IMAGE_SIZES):
        paths[101 + i] = f"{101 + i:012d}.jpg"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, paths[101 + i]), format="JPEG", quality=90)
    return StimuliDataset(img_paths=paths, captions=dict(zip(paths, CAPTIONS)), root=str(root))


def _extract(dataset, out_path, device="cpu"):
    params = IB.params_from_torch_state_dict(IB.fake_torch_state_dict(IB_TINY, seed=3),
                                             IB_TINY, device=device)
    extract_fn = IB.make_imagebind_extractor(params, IB_TINY, tokenizer=_words)
    return run_extraction(extract_fn, "imagebind", dataset, batch_size=BATCH,
                          out_path=str(out_path), progress=False)


def test_extraction_is_bit_equal_with_spans_on(tmp_path, monkeypatch):
    dataset = _extraction_dataset(tmp_path)
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _fail)
        off = _extract(dataset, tmp_path / "off.pkl")
    assert P.summary() == {"spans": {}, "counters": {}}
    with _cpu_profile():
        on = _extract(dataset, tmp_path / "on.pkl")
    assert off.keys() == on.keys()
    for sid in off:
        assert off[sid].keys() == on[sid].keys()
        for key in off[sid]:
            np.testing.assert_array_equal(off[sid][key], on[sid][key])
    assert (tmp_path / "off.pkl").read_bytes() == (tmp_path / "on.pkl").read_bytes()


def test_extraction_spans_count_nest_and_add_up(tmp_path):
    dataset = _extraction_dataset(tmp_path)
    with _cpu_profile() as prof:
        _extract(dataset, tmp_path / "f.pkl")
    n_batches = -(-len(IMAGE_SIZES) // BATCH)
    s = P.summary()
    spans = s["spans"]
    inner = ("mdt.extract.tokens", "mdt.extract.prep", "mdt.extract.forward",
             "mdt.extract.to_host")
    assert {name: spans[name]["count"] for name in spans} == dict(
        {name: n_batches for name in ("mdt.extract.load", "mdt.extract.batch") + inner},
        **{"mdt.extract.save": 1})
    # the generator loads a batch's images before the loop's body opens the
    # batch: a sibling; the extractor's stages lie inside the batch
    events = [e for e in prof.events() if e.name.startswith("mdt.extract.")]
    for e in events:
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        assert parent == ("mdt.extract.batch" if e.name in inner else None), e.name
    batch = spans["mdt.extract.batch"]
    assert batch["host_s"] >= sum(spans[name]["host_s"] for name in inner)
    assert all(v["stream_s"] is None for v in spans.values())

    tokens = sum(min(len(t), IB_TINY.context_length - 2) + 2 for t in _words(CAPTIONS))
    assert s["counters"] == {"mdt.extract.stimuli": len(IMAGE_SIZES),
                             "mdt.extract.decoded_pixels": sum(w * h for w, h in IMAGE_SIZES),
                             "mdt.extract.text_tokens": tokens}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spans' stream events and device annotations)")
    return torch.device("cuda")


def _chrome_events(log_dir):
    """The events of the one Chrome trace ``device_trace`` wrote into ``log_dir``."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _kernels_by_span(events) -> dict:
    """{(start, end, name) of a host span: [(start, end) of each kernel whose
    launch the span is the innermost ``mdt.*`` span of]}, the kernels linked
    to their launches by correlation id."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("mdt.")]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        t = launches.get(e.get("args", {}).get("correlation"))
        if e.get("cat") != "kernel" or t is None:
            continue
        holders = [s for s in spans if s[0] <= t <= s[1]]
        if holders:
            out.setdefault(max(holders), []).append((e["ts"], e["ts"] + e["dur"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cv", "fixed"])
def test_block_kernels_lie_inside_their_spans_on_the_card(cuda, tmp_path, mode):
    _run_searchlight(mode, device=cuda)  # builds and warms every path
    torch.cuda.synchronize()
    P.reset()
    log_dir = str(tmp_path / "trace")
    with P.device_trace(log_dir):
        _, aux = _run_searchlight(mode, device=cuda)
        torch.cuda.synchronize()
    spans = P.summary()["spans"]
    n_blocks = aux["n_blocks"]
    assert spans["mdt.engine.step"]["count"] == n_blocks
    timed = ["mdt.runner.block", "mdt.engine.step", "mdt.engine.fit", "mdt.engine.solve",
             "mdt.engine.score"]
    for name in timed + (["mdt.engine.select"] if mode == "cv" else []):
        assert spans[name]["stream_s"] > 0, name
    assert spans["mdt.runner.block"]["stream_s"] >= spans["mdt.engine.step"]["stream_s"]

    # on the device each span shows as an annotation over the kernels it
    # launched itself (those of its child spans show under the children's)
    events = _chrome_events(log_dir)
    on_device = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e["name"].startswith("mdt."):
            on_device.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    by_span = _kernels_by_span(events)
    named = {name for _, _, name in by_span}
    assert {"mdt.engine.gather", "mdt.engine.fit", "mdt.engine.solve",
            "mdt.engine.score"} <= named
    assert ("mdt.engine.select" in named) == (mode == "cv")
    # each block's gram and cross products, in the fixed step and in the
    # CV selection alike
    assert sum(name == "mdt.engine.fit" for _, _, name in by_span) == n_blocks
    for (_, _, name), kernels in by_span.items():
        first, last = min(a for a, _ in kernels), max(b for _, b in kernels)
        # Chrome trace times are microseconds, to the nanosecond
        assert any(d0 - 1e-3 <= first and last <= d1 + 1e-3
                   for d0, d1 in on_device.get(name, [])), name


@pytest.mark.cuda
def test_fast_math_counts_its_bf16_products_on_the_card(cuda):
    """``--fast-math``'s fixed-alpha step on the card: four bf16 GEMMs a block
    (the gram, X^T Y, the test and the imagery predictions), each counted as
    ``mdt.precision.bf16``, the gram and X^T Y inside ``mdt.engine.fit``."""
    from multimodal_decoding_tpu_torch.decoding.searchlight import precision_arguments

    def run():
        return run_searchlight(**_searchlight_inputs(), alpha=1.0, block_size=8, device=cuda,
                               progress=False, **precision_arguments(True))

    off_scores, _ = run()
    assert P.summary()["counters"] == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on_scores, aux = run()
    _assert_equal_outputs(off_scores, on_scores)
    s = P.summary()
    assert s["counters"]["mdt.precision.bf16"] == 4 * aux["n_blocks"]
    assert s["spans"]["mdt.engine.fit"]["count"] == aux["n_blocks"]
    assert s["spans"]["mdt.engine.fit"]["stream_s"] > 0


@pytest.mark.cuda
def test_tower_kernels_lie_inside_the_forward_span_on_the_card(cuda, tmp_path):
    """Every kernel the extraction loop launches is one of the towers', inside
    ``mdt.extract.forward`` on the host and under its annotation on the
    device; the span's stream time is read from its events."""
    dataset = _extraction_dataset(tmp_path)
    _extract(dataset, tmp_path / "warm.pkl", device=cuda)
    torch.cuda.synchronize()
    P.reset()
    log_dir = str(tmp_path / "trace")
    with P.device_trace(log_dir):
        _extract(dataset, tmp_path / "f.pkl", device=cuda)
        torch.cuda.synchronize()
    spans = P.summary()["spans"]
    n_batches = -(-len(IMAGE_SIZES) // BATCH)
    assert spans["mdt.extract.forward"]["count"] == n_batches
    assert spans["mdt.extract.forward"]["stream_s"] > 0
    assert spans["mdt.extract.batch"]["stream_s"] >= spans["mdt.extract.forward"]["stream_s"]

    events = _chrome_events(log_dir)
    on_device = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "gpu_user_annotation" and e["name"] == "mdt.extract.forward"]
    by_span = _kernels_by_span(events)
    assert {name for _, _, name in by_span} == {"mdt.extract.forward"}
    assert len(by_span) == n_batches
    for kernels in by_span.values():
        first, last = min(a for a, _ in kernels), max(b for _, b in kernels)
        assert any(d0 - 1e-3 <= first and last <= d1 + 1e-3 for d0, d1 in on_device)
