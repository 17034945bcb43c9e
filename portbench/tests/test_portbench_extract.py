"""The extraction cell at a tiny size on the CPU: the reference's image
transform against Pillow, a sound run, the faults the comparison has to
catch, and the counts against PyTorch's flop counter.

Each fault is planted in the program after set-up and removed before the
check, so the reference runs unbroken: the vision embedding left
unnormalised, the text's logit scale dropped, the text state taken at the
last position instead of EOT, a bilinear resize, LayerNorm at eps 1e-5, no
causal mask, and an entry altered in the pickle.  Each has to read at least
100x the sound run's number on the same seed (the pickle: a fault where the
sound run counts none).
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from portbench.harness import bench, judge
from portbench.reference import extract_imagebind as ref

CONFIG, TRAFFIC = "extract-imagebind-huge", "extract-imagebind"
SEED = 2_718_281_828
counts = bench.counts("extract_imagebind")


def tiny_cell():
    """``(configuration, traffic, driver name)`` at the driver's tiny sizes,
    from the files, as no entry of ``BENCHMARK.json`` names them yet."""
    traffic = bench.traffic(TRAFFIC)
    drv = bench.module("drivers", traffic["driver"])
    return (dict(bench.config(CONFIG), **drv.TINY_CONFIG), dict(traffic, **drv.TINY_TRAFFIC),
            traffic["driver"])


def driver(seed: int = SEED):
    config, traffic, kind = tiny_cell()
    drv = bench.module("drivers", kind).Driver(config, traffic, seed, "cpu")
    drv.setup()
    return drv


def run(plant=None, seed: int = SEED) -> dict:
    """Set-up, a window with ``plant(driver)`` in force, the check without it."""
    drv = driver(seed)
    with (plant(drv) if plant else contextlib.nullcontext()):
        drv.window(0.2)
    drv.release()
    return drv.check()


@pytest.fixture(scope="module")
def sound():
    return run()


# -- the image transform -------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((672, 448), (336, 224)), ((448, 672), (224, 336)),
                                     ((640, 480), (298, 224)), ((640, 427), (335, 224)),
                                     ((84, 56), (42, 28)), ((20, 30), (40, 60)),
                                     ((100, 100), (100, 50))])
def test_resize_is_pillows_bit_for_bit(src, dst):
    img = np.random.default_rng(sum(src + dst)).integers(0, 256, (src[1], src[0], 3),
                                                         dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BICUBIC))
    np.testing.assert_array_equal(ref.resize_bicubic(img, *dst), want)


def test_transform_follows_torchvision():
    """Resize(224): the long side int(224 * long / short), not rounded;
    CenterCrop: the offset round((size - 224) / 2)."""
    img = np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    x = ref.transform(img, 224)
    resized = ref.resize_bicubic(img, 298, 224)[:, 37:261].astype(np.float64) / 255.0
    want = ((resized - ref.IMAGE_MEAN) / ref.IMAGE_STD).transpose(2, 0, 1)
    np.testing.assert_array_equal(x, want)
    assert ref.transform(img.transpose(1, 0, 2), 224).shape == (3, 224, 224)


# -- sound runs and inputs -----------------------------------------------------


def test_sound_run_is_correct(sound):
    assert judge.verdict(sound, tiny_cell()[1]["limits"])[0], sound
    assert sound["sampled"] >= tiny_cell()[1]["stimuli_per_call"]  # every stimulus done
    assert 0 < max(sound["emb_gap_text"], sound["emb_gap_vision"]) < 1e-5


def test_same_seed_same_inputs():
    a, b, c = driver(5), driver(5), driver(6)
    assert a.caption_ids == b.caption_ids and a.caption_ids != c.caption_ids
    first = a.ids[0]
    files = [open(f"{d.dataset.root}/{d.paths[first]}", "rb").read() for d in (a, b)]
    assert files[0] == files[1]
    sd = [torch.load(d.ckpt, weights_only=True) for d in (a, b, c)]
    key = "modality_trunks.vision.blocks.1.mlp.fc1.weight"
    assert torch.equal(sd[0][key], sd[1][key]) and not torch.equal(sd[0][key], sd[2][key])
    for d in (c, b, a):  # the drivers' look-ups undone last in, first out
        d.release()


def test_checkpoint_is_the_official_layout_in_pools():
    config = tiny_cell()[0]
    drv = driver()
    sd = torch.load(drv.ckpt, weights_only=True)
    shapes = ref.checkpoint_shapes(config)
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    storages = {v.untyped_storage().data_ptr() for v in sd.values()}
    assert len(storages) < 12  # a few pools, not a storage a tensor
    drv.release()


def test_overlapping_rows_load_through_the_program(monkeypatch):
    """A pool smaller than the token embedding (as at full width): its rows
    overlap, and the program loads and runs them as any other tensor."""
    monkeypatch.setattr(bench.module("drivers", "extract_imagebind"), "POOL_CAP", 1 << 20)
    drv = driver()
    emb = torch.load(drv.ckpt, weights_only=True)[
        "modality_preprocessors.text.token_embedding.weight"]
    assert emb.stride()[0] < emb.shape[1]
    drv.window(0.1)
    drv.release()
    assert judge.verdict(drv.check(), tiny_cell()[1]["limits"])[0]


# -- the faults ----------------------------------------------------------------


@contextlib.contextmanager
def hooks(*pairs):
    handles = [getattr(module, f"register_{kind}")(fn) for module, kind, fn in pairs]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def vision_unnormalised(drv):
    v, seen = drv.model.vision, {}
    return hooks((v.head, "forward_hook", lambda m, i, o: seen.update(head=o)),
                 (v, "forward_hook", lambda m, i, o: seen["head"]))


def logit_scale_dropped(drv):
    return hooks((drv.model.text, "forward_hook",
                  lambda m, i, o: o / torch.linalg.vector_norm(o, dim=-1, keepdim=True)))


def eot_at_last_position(drv):
    t, seen = drv.model.text, {}
    return hooks((t.blocks[-1], "forward_hook", lambda m, i, o: seen.update(x=o)),
                 (t.head_ln, "forward_pre_hook", lambda m, args: (seen["x"][:, -1],)))


def no_causal_mask(drv):
    return hooks(*[(b, "forward_pre_hook", lambda m, args: (args[0], None))
                   for b in drv.model.text.blocks])


@contextlib.contextmanager
def layer_norm_eps(drv):
    norms = [m for m in drv.model.modules() if isinstance(m, torch.nn.LayerNorm)]
    for m in norms:
        m.eps = 1e-5
    try:
        yield
    finally:
        for m in norms:
            m.eps = ref.LN_EPS


@contextlib.contextmanager
def bilinear_resize(drv):
    bicubic = Image.BICUBIC
    Image.BICUBIC = Image.BILINEAR
    try:
        yield
    finally:
        Image.BICUBIC = bicubic


@contextlib.contextmanager
def pickle_entry_altered(drv):
    dump = pickle.dump

    def altered(obj, f, *a, **k):
        obj = copy.deepcopy(obj)
        entry = obj[next(iter(obj))]
        key = next(iter(entry))
        entry[key] = entry[key] + np.float32(1e-3)
        dump(obj, f, *a, **k)
    pickle.dump = altered
    try:
        yield
    finally:
        pickle.dump = dump


FAULTS = {
    "vision_unnormalised": (vision_unnormalised, "emb_gap_vision"),
    "logit_scale_dropped": (logit_scale_dropped, "emb_gap_text"),
    "eot_at_last_position": (eot_at_last_position, "emb_gap_text"),
    "bilinear_resize": (bilinear_resize, "emb_gap_vision"),
    "layer_norm_eps": (layer_norm_eps, "emb_gap_text"),
    "no_causal_mask": (no_causal_mask, "emb_gap_text"),
    "pickle_entry_altered": (pickle_entry_altered, "pickle_faults"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails_its_number_by_100x(fault, sound):
    plant, number = FAULTS[fault]
    numbers = run(plant)
    limits = tiny_cell()[1]["limits"]
    assert not judge.verdict(numbers, limits)[0], numbers
    assert numbers[number] > limits[number]
    if sound[number]:
        assert numbers[number] >= 100 * sound[number], (numbers, sound)
    else:
        assert numbers[number] >= 1


DRIVER_FAULTS = bench.module("drivers", "extract_imagebind").FAULTS


@pytest.mark.parametrize("fault", DRIVER_FAULTS)
def test_contracts_fault_is_not_correct(fault, monkeypatch):
    """The contract's faults (state unchanged, half the batch, an answer
    altered), planted in the program for the whole run."""
    for module, attr, plant in DRIVER_FAULTS[fault]:
        module = importlib.import_module(module)
        monkeypatch.setattr(module, attr, plant(getattr(module, attr)))
    drv = driver()
    for _ in range(2):  # a stale answer shows only beside a call that differs from the first
        drv.window(0.2)
    drv.release()
    numbers = drv.check()
    assert not judge.verdict(numbers, tiny_cell()[1]["limits"])[0], numbers


# -- the counts and their readers ------------------------------------------------


@pytest.mark.parametrize("widths", [{}, dict(vision_heads=4, text_heads=1, mlp_ratio=2.0,
                                             context_length=40, image_size=42)])
def test_counts_equal_the_flop_counter(widths):
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_decoding_tpu_torch.extraction import imagebind as ib
    from multimodal_decoding_tpu_torch.utils import threefry

    config = dict(tiny_cell()[0], **widths)
    cfg = ib.ImageBindConfig(**{k: config[k] for k in bench.module(
        "drivers", "extract_imagebind").WIDTHS})
    model = ib.init_params(threefry.prng_key(0), cfg, "cpu")
    b = 3
    ids = ref.tokens([[5] * 9, [7] * 12, [9] * 20], cfg.context_length)
    px = torch.randn(b, 3, cfg.image_size, cfg.image_size)
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        ib.imagebind_embed(model, cfg, ids, px)
    terms = counts.terms(config, [11, 14, 22])
    assert sum(f for f, _ in terms.values()) == fc.get_total_flops()
    params = sum(p.numel() for p in model.parameters())
    gathered = b * cfg.context_length * cfg.text_embed_dim
    assert terms["weights"][1] == 4 * (params - model.text.token_embed.numel() + gathered)


def test_full_width_work_per_stimulus():
    total = sum(counts.flops_per_stimulus(bench.config(CONFIG)).values())
    assert 3.8e11 < total < 3.85e11  # vision 32 x 10.44, text 24 x 1.96, stem 0.77 GFLOP


def test_readers():
    config = bench.config(CONFIG)
    tokens = [[12] * 10] * 6
    flops = 60 * sum(counts.flops_per_stimulus(config).values())
    record = {"stimuli": 60, "window_s": 2.0, "batches": 6, "batch_tokens": tokens,
              "load_s": 0.3, "preprocess_s": 0.3}
    trace = {"busy_s": 1.5, "window_s": 2.0,
             "spans": {"portbench.extract_forward": {"count": 6, "kernel_s": 1.2}}}
    ctx = SimpleNamespace(config=config, counts=bench.counts, record=record, trace=trace)
    read = {m: bench.reader(m).read(ctx) for m in (
        "extract_stimuli_per_s", "extract_mfu", "extract_forward_roofline_share",
        "extract_forward_ms", "extract_prep_ms", "extract_device_idle_share")}
    assert read["extract_stimuli_per_s"] == pytest.approx(30.0)
    assert read["extract_mfu"] == pytest.approx(100 * flops / 67e12 / 2.0)
    assert read["extract_forward_roofline_share"] == pytest.approx(100 * flops / 67e12 / 1.2)
    assert read["extract_forward_ms"] == pytest.approx(200.0)
    assert read["extract_prep_ms"] == pytest.approx(100.0)
    assert read["extract_device_idle_share"] == pytest.approx(25.0)
    ctx.trace, ctx.record = None, {"window_s": 2.0}
    assert all(bench.reader(m).read(ctx) is None for m in read)
