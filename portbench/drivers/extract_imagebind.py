"""Driver of the extraction cell: the feature-extraction CLI's loop over
ImageBind-Huge (``cli/extract_features.py --model imagebind``).

Set-up writes, from the seed, under a fresh directory of
``portbench/.work``: the stimuli, ``n_stimuli`` RGB JPEGs of the traffic's
``image_sizes`` (each size as often as the others, in a seeded order; noise
smoothed over the octaves ``image_octaves`` so that a file is of COCO's
order) and the stim-info CSV the program's ``StimuliDataset.from_csv``
reads (``img_path``, ``caption``, ``used``); and the checkpoint, in the
official ``imagebind_huge.pth`` key layout (``reference.checkpoint_shapes``),
each tensor a view into one of a few pools drawn on the device (normal,
scaled by ``fan_in ** -0.5`` per fan-in, 0.02 for embeddings and biases;
LayerNorm weights 1), so the file holds ~150 MB for 0.99e9 weights.  A
caption is ``caption_tokens`` seeded BPE ids written as words (``w<id>``);
the benchmark's tokenizer (``bpe_ids``) reads them back, as the CLIP BPE
vocabulary is not in the repository: ``imagebind.clip_tokenize`` is the one
look-up replaced, to hand it that tokenizer.  Then what the CLI's ``main``
does before its loop: the dataset, and ``build_extractor`` with
``$IMAGEBIND_CKPT`` pointing at the checkpoint (the pretrained path:
``params_from_torch_state_dict``), and one warm-up batch.

Each window call is the CLI's loop, ``harness.run_extraction`` with the
registry's batch size, over a dataset of the next ``stimuli_per_call``
stimuli (in order, wrapping round), into a fresh pickle: the PIL loads,
``preprocess_images``, tokenisation, both towers, the features to the host,
the dict by stimulus id and the pickle.  The driver times the image loads
and ``preprocess_images`` on the host; with tracing on, it also wraps
``imagebind.imagebind_embed`` in the span ``portbench.extract_forward``,
which ends in a device synchronisation so that the towers' kernels fall
inside it.  Untraced, ``imagebind_embed`` is the program's own.

The check, after the window, against ``reference/extract_imagebind.py``:
``emb_gap_text`` and ``emb_gap_vision``, the widest distance of a sampled
stimulus's embedding from the float64 reference's over the reference's norm
(the JPEGs decoded with PIL, the ids, the checkpoint file); ``pickle_faults``,
the last call's pickle read back against what the call returned (ids, keys,
shapes, dtypes, values) and the returned dict against the study's schema.
The control (``control.py``'s TF32 switch): the reference in float32 with
TF32 products, put in the program's place.

Configuration keys: ``model`` and the widths ``WIDTHS``.  Traffic keys:
``n_stimuli``, ``image_sizes``, ``image_octaves``, ``octave_decay``,
``fine_noise``, ``jpeg_quality``, ``caption_tokens``, ``stimuli_per_call``,
``mode``, ``sample``, ``reference_chunk``, ``limits``.  ``TINY_CONFIG``,
``TINY_TRAFFIC`` and ``FAULTS`` as in ``drivers/searchlight.py``.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import gc
import math
import os
import pickle
import shutil
import tempfile
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import bench, data
from portbench.reference import extract_imagebind as reference
from portbench.tests.faults import stale

WORK = os.path.join(bench.BENCH_DIR, ".work")
FORWARD_SPAN = "portbench.extract_forward"
CALL_SPAN = "portbench.run_extraction"
IMAGEBIND = "multimodal_decoding_tpu_torch.extraction.imagebind"
# the configuration's keys that size the model (extraction/imagebind.ImageBindConfig)
WIDTHS = ("vision_embed_dim", "vision_layers", "vision_heads", "text_embed_dim", "text_layers",
          "text_heads", "out_embed_dim", "image_size", "patch_size", "n_frames",
          "context_length", "vocab_size", "logit_scale_init", "mlp_ratio")
POOL_CAP = 1 << 23  # floats a weight pool holds at most
STREAM_STIMULI, STREAM_WEIGHTS = 11, 12  # numpy streams of a seed, beside harness/data's

TINY_CONFIG = dict(vision_embed_dim=32, vision_layers=2, vision_heads=2, text_embed_dim=32,
                   text_layers=2, text_heads=2, out_embed_dim=16, image_size=28)
TINY_TRAFFIC = dict(n_stimuli=40, image_sizes=[[84, 56], [56, 84]], stimuli_per_call=20,
                    sample=1000)


def bpe_ids(captions) -> list:
    """The benchmark's tokenizer: a caption's words ``w<id>`` as BPE ids,
    without specials."""
    return [[int(w[1:]) for w in c.split()] for c in captions]


def _with_tokenizer(clip_tokenize):
    def tokenize(captions, cfg, tokenizer=None):
        return clip_tokenize(captions, cfg, tokenizer or bpe_ids)
    return tokenize


def half_batch(fn):
    """Both towers run on the first half of the batch; the other half's
    embeddings repeat them."""
    def embed(params, cfg, input_ids, pixel_values):
        n = len(input_ids)
        text, vision = fn(params, cfg, input_ids[:max(1, n // 2)], pixel_values[:max(1, n // 2)])
        rows = torch.arange(n, device=text.device) % len(text)
        return text[rows], vision[rows]
    return embed


def altered_row(fn):
    """A batch's first vision embedding moved by 0.25 in one coordinate."""
    def embed(*a, **k):
        text, vision = fn(*a, **k)
        vision = vision.clone()
        vision[0, 0] += 0.25
        return text, vision
    return embed


FAULTS = {
    "state_unchanged": [(IMAGEBIND, "imagebind_embed", stale)],
    "half_batch": [(IMAGEBIND, "imagebind_embed", half_batch)],
    "answer_altered": [(IMAGEBIND, "imagebind_embed", altered_row)],
}
FAULT_NUMBERS = {"answer_altered": "emb_gap_vision"}


def _group(key: str, shape: tuple) -> tuple:
    """(pool, scale) of a checkpoint tensor: LayerNorm weights 1; embeddings,
    class token and biases 0.02; a weight matrix ``fan_in ** -0.5``."""
    if len(shape) == 1:
        ln = key.endswith(("norm_1.weight", "norm_2.weight", "pre_transformer_layer.0.weight",
                           "vision.0.weight", "proj.0.weight"))
        return ("ones", 1.0) if ln else ("small", 0.02)
    if "token_embedding" in key or "pos_embed" in key or "cls_token" in key:
        return "small", 0.02
    fan_in = math.prod(shape[1:])
    return f"fan{fan_in}", fan_in ** -0.5


def draw_checkpoint(cfg: dict, gen: torch.Generator, r: np.random.Generator, device) -> dict:
    """The official key layout at the configuration's widths, each tensor a
    view of a pool drawn on ``device`` and kept on the host: a pool holds
    1.25x its largest tensor (at most ``POOL_CAP`` floats), each tensor sits
    at a seeded offset; a matrix larger than its pool takes overlapping rows,
    the stride the largest that fits."""
    shapes = reference.checkpoint_shapes(cfg)
    pools = {}
    for key, shape in shapes.items():
        if key.endswith(("log_logit_scale", "text.mask")):
            continue
        pools.setdefault(_group(key, shape), []).append(key)
    sd = {}
    for (name, scale), keys in pools.items():
        size = min(int(1.25 * max(math.prod(shapes[k]) for k in keys)) + 1, POOL_CAP)
        pool = (torch.ones(size) if name == "ones" else
                torch.randn(size, generator=gen, device=device).mul_(scale).cpu())
        for k in keys:
            shape, n = shapes[k], math.prod(shapes[k])
            if n <= size:
                off = int(r.integers(0, size - n + 1))
                sd[k] = pool[off:off + n].view(shape)
            else:
                rows, cols = shape
                step = (size - cols) // (rows - 1)
                off = int(r.integers(0, size - (rows - 1) * step - cols + 1))
                sd[k] = pool.as_strided((rows, cols), (step, 1), off)
    sd["modality_postprocessors.text.1.log_logit_scale"] = torch.tensor(
        math.log(cfg["logit_scale_init"]), dtype=torch.float32)
    sd["modality_preprocessors.text.mask"] = reference.causal_mask(cfg["context_length"])
    return sd


def smooth_images(gen: torch.Generator, n: int, height: int, width: int, tr: dict,
                  device) -> np.ndarray:
    """[n, height, width, 3] uint8: uniform noise on grids of every
    ``image_octaves`` pixels, upsampled bicubically, each octave's amplitude
    ``octave_decay`` times the last's, and pixel noise of ``fine_noise``."""
    x = torch.zeros((n, 3, height, width), device=device)
    for i, step in enumerate(tr["image_octaves"]):
        grid = torch.rand((n, 3, max(2, height // step), max(2, width // step)), generator=gen,
                          device=device).sub_(0.5)
        x += tr["octave_decay"] ** i * F.interpolate(grid, size=(height, width), mode="bicubic",
                                                     align_corners=False)
    x += tr["fine_noise"] * torch.rand(x.shape, generator=gen, device=device).sub_(0.5)
    x = x.mul_(255).add_(128).clamp_(0, 255).to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous().cpu().numpy()


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.calls: list = []  # (stimulus ids, returned features, pickle path) per window call
        self.setup_seconds: dict = {}
        self.patches = contextlib.ExitStack()  # the driver's look-ups, undone on release
        self.workdir = None

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from multimodal_decoding_tpu_torch.extraction import harness
        from multimodal_decoding_tpu_torch.extraction import imagebind as ib
        from multimodal_decoding_tpu_torch.extraction.extractors import REGISTRY, build_extractor

        phases = bench.Phases(self.device)
        os.makedirs(WORK, exist_ok=True)
        self.workdir = tempfile.mkdtemp(prefix="extract-imagebind-", dir=WORK)
        weakref.finalize(self, shutil.rmtree, self.workdir, True)
        gen = data.generator(self.seed, self.device)
        self._stimuli(gen)
        phases.mark("stimuli")
        self.ckpt = os.path.join(self.workdir, "imagebind_huge.pth")
        torch.save(draw_checkpoint(self.cfg, gen, data.rng(self.seed, STREAM_WEIGHTS),
                                   self.device), self.ckpt)
        phases.mark("checkpoint")

        self.dataset = harness.StimuliDataset.from_csv(self.csv, os.path.join(self.workdir,
                                                                              "images"))
        self.ids = self.dataset.stimuli_ids
        phases.mark("dataset")
        self.patches.enter_context(mock.patch.dict(os.environ, IMAGEBIND_CKPT=self.ckpt))
        self.patches.enter_context(mock.patch.object(ib, "clip_tokenize",
                                                     _with_tokenizer(ib.clip_tokenize)))
        widths = {k: self.cfg[k] for k in WIDTHS}
        # the CLI's call; build_extractor's ImageBindConfig() made at the
        # configuration's widths (the defaults at full width)
        with mock.patch.object(ib, "ImageBindConfig", functools.partial(ib.ImageBindConfig,
                                                                         **widths)):
            self.model, cfg, self.extract_fn = build_extractor(self.cfg["model"],
                                                               device=self.device)
        if cfg != ib.ImageBindConfig(**widths):
            raise ValueError(f"build_extractor built {cfg}, not the configuration's widths")
        self.batch_size = REGISTRY[self.cfg["model"]].batch_size
        phases.mark("model")
        harness.run_extraction(self.extract_fn, self.cfg["model"],
                               self._subset(self.ids[-self.batch_size:]),
                               batch_size=self.batch_size,
                               out_path=os.path.join(self.workdir, "warmup.pkl"),
                               mode=self.tr["mode"], progress=False)
        self.next = 0
        phases.mark("warmup")
        self.setup_seconds = phases.seconds

    def _stimuli(self, gen: torch.Generator) -> None:
        """The JPEGs, the captions' ids and the stim-info CSV."""
        tr, n = self.tr, self.tr["n_stimuli"]
        r = data.rng(self.seed, STREAM_STIMULI)
        coco_ids = r.choice(np.arange(1, 600_000), n, replace=False)
        sizes = r.permutation(np.resize(np.arange(len(tr["image_sizes"])), n))
        lo, hi = tr["caption_tokens"]
        lengths = r.permutation(np.resize(np.arange(lo, hi + 1), n))
        if self.cfg["vocab_size"] <= reference.EOT:
            raise ValueError("the program's SOT and EOT ids need the full CLIP vocabulary")
        words = r.integers(0, reference.SOT, int(lengths.sum()))
        bounds = np.concatenate([[0], np.cumsum(lengths)])
        self.caption_ids = {int(c): words[a:b].tolist()
                            for c, a, b in zip(coco_ids, bounds[:-1], bounds[1:])}
        self.paths = {int(c): f"{int(c):012d}.jpg" for c in coco_ids}
        images = os.path.join(self.workdir, "images")
        os.makedirs(images)
        nbytes = 0

        def write(item):
            from PIL import Image

            path, pixels = item
            Image.fromarray(pixels).save(path, format="JPEG", quality=tr["jpeg_quality"])
            return os.path.getsize(path)

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for s, (width, height) in enumerate(tr["image_sizes"]):
                which = coco_ids[sizes == s]
                for a in range(0, len(which), 64):
                    chunk = which[a:a + 64]
                    pixels = smooth_images(gen, len(chunk), height, width, tr, self.device)
                    nbytes += sum(pool.map(write, [(os.path.join(images, self.paths[int(c)]),
                                                    p) for c, p in zip(chunk, pixels)]))
        self.jpeg_mean_bytes = nbytes / n
        self.csv = os.path.join(self.workdir, "stim_info.csv")
        with open(self.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["coco_id", "img_path", "caption", "used"])
            for c in coco_ids:
                c = int(c)
                w.writerow([c, self.paths[c], " ".join(f"w{t}" for t in self.caption_ids[c]),
                            True])

    def _subset(self, ids: list, timing: dict | None = None):
        """The program's dataset of the stimuli ``ids``, in that order; with
        ``timing``, its image loads timed on the host."""
        from multimodal_decoding_tpu_torch.extraction.harness import StimuliDataset

        ds = StimuliDataset(img_paths={i: self.dataset.img_paths[i] for i in ids},
                            captions={i: self.dataset.captions[i] for i in ids},
                            root=self.dataset.root)
        if timing is not None:
            load = ds.load_image

            def timed_load(i):
                t = time.perf_counter()
                img = load(i)
                timing["load_s"] += time.perf_counter() - t
                return img
            ds.load_image = timed_load
        return ds

    # -- the program --------------------------------------------------------

    @contextlib.contextmanager
    def _instrumented(self, span, timing: dict):
        """``preprocess_images`` timed while open; with tracing on (``span``
        records), ``imagebind_embed`` in the forward span, ending in a device
        synchronisation, its host seconds in ``timing["forward_s"]``."""
        from multimodal_decoding_tpu_torch.extraction import imagebind as ib

        embed, prep = ib.imagebind_embed, ib.preprocess_images

        def forward(*a, **k):
            t = time.perf_counter()
            with span(FORWARD_SPAN):
                out = embed(*a, **k)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            timing["forward_s"] = timing.get("forward_s", 0.0) + time.perf_counter() - t
            return out

        def preprocess(*a, **k):
            t = time.perf_counter()
            out = prep(*a, **k)
            timing["preprocess_s"] += time.perf_counter() - t
            return out
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(ib, "preprocess_images", preprocess))
            if not isinstance(span(FORWARD_SPAN), contextlib.nullcontext):
                stack.enter_context(mock.patch.object(ib, "imagebind_embed", forward))
            yield

    def window(self, seconds: float, span=contextlib.nullcontext) -> dict:
        """Calls of the CLI's loop until ``seconds`` have passed; returns the
        window's record.  ``span(name)`` wraps each call, and with tracing on
        each forward."""
        from multimodal_decoding_tpu_torch.extraction.harness import run_extraction

        per_call, n = self.tr["stimuli_per_call"], len(self.ids)
        timing = {"load_s": 0.0, "preprocess_s": 0.0}
        call_seconds, batch_tokens = [], []
        features = os.path.join(self.workdir, "features")
        os.makedirs(features, exist_ok=True)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        with self._instrumented(span, timing):
            t0 = time.perf_counter()
            while True:
                ids = [self.ids[(self.next + i) % n] for i in range(per_call)]
                self.next = (self.next + per_call) % n
                path = os.path.join(features, f"call-{len(self.calls)}.pkl")
                t_call = time.perf_counter()
                with span(CALL_SPAN):
                    feats = run_extraction(self.extract_fn, self.cfg["model"],
                                           self._subset(ids, timing), batch_size=self.batch_size,
                                           out_path=path, mode=self.tr["mode"], progress=False)
                call_seconds.append(time.perf_counter() - t_call)
                self.calls.append((ids, feats, path))
                batch_tokens += [[len(self.caption_ids[i]) + 2 for i in ids[b:b + self.batch_size]]
                                 for b in range(0, len(ids), self.batch_size)]
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        rec = dict(timing, window_s=window_s, stimuli=sum(len(c[0]) for c in self.calls),
                   calls=len(call_seconds), batches=len(batch_tokens), batch_tokens=batch_tokens,
                   call_seconds=call_seconds, jpeg_mean_bytes=self.jpeg_mean_bytes)
        if self.device.type == "cuda":
            rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return rec

    def _feature_keys(self) -> tuple:
        from multimodal_decoding_tpu_torch.config import LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY

        return LANG_CLS_FEAT_KEY, VISION_CLS_FEAT_KEY

    def _sound(self, entry) -> bool:
        shape = (self.cfg["out_embed_dim"],)
        return (isinstance(entry, dict) and set(entry) == set(self._feature_keys())
                and all(np.shape(v) == shape and np.all(np.isfinite(v)) for v in entry.values()))

    def attempted_failed(self) -> tuple:
        stimuli = [(i, feats.get(int(i))) for ids, feats, _ in self.calls for i in ids]
        return len(stimuli), sum(not self._sound(entry) for _, entry in stimuli)

    def release(self) -> None:
        """Drop the program's model and undo the driver's look-ups before the
        reference runs."""
        self.patches.close()
        self.model = self.extract_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def sample(self) -> list:
        done = list(dict.fromkeys(int(i) for ids, _, _ in self.calls for i in ids))
        k = min(self.tr["sample"], len(done))
        return [int(i) for i in data.rng(self.seed, data.STREAM_SAMPLE).choice(done, k,
                                                                               replace=False)]

    def program_answers(self, picks: list) -> dict:
        """The window's embeddings of the stimuli ``picks``, each from its
        latest call."""
        latest = {}
        for _, feats, _ in self.calls:
            latest.update(feats)
        text_key, vision_key = self._feature_keys()
        return {"text": np.stack([latest[p][text_key] for p in picks]),
                "vision": np.stack([latest[p][vision_key] for p in picks])}

    def reference(self, picks: list, dtype=torch.float32) -> dict:
        """The plain reference's embeddings of ``picks``, from the JPEG files
        (decoded with PIL), the captions' ids and the checkpoint file."""
        from PIL import Image

        images = []
        for p in picks:
            with Image.open(os.path.join(self.dataset.root, self.paths[p])) as img:
                images.append(np.asarray(img.convert("RGB")))
        return reference.embed(self.ckpt, images, [self.caption_ids[p] for p in picks],
                               self.cfg, dtype, self.device, self.tr["reference_chunk"])

    def pickle_faults(self) -> int:
        """Faults of the last call: its returned dict against the study's
        schema (the call's ids; each entry the two keys, float32 [out]), and
        its pickle, read back, against the returned dict."""
        ids, feats, path = self.calls[-1]
        keys, shape = set(self._feature_keys()), (self.cfg["out_embed_dim"],)
        faults = len({int(i) for i in ids} ^ set(feats))
        for entry in feats.values():
            faults += len(set(entry) ^ keys)
            faults += sum(v.dtype != np.float32 or v.shape != shape for v in entry.values())
        with open(path, "rb") as f:
            back = pickle.load(f)
        faults += len(set(feats) ^ set(back))
        for sid in set(feats) & set(back):
            a, b = feats[sid], back[sid]
            faults += len(set(a) ^ set(b))
            faults += sum(not (isinstance(b[k], np.ndarray) and b[k].dtype == a[k].dtype
                               and np.array_equal(a[k], b[k])) for k in set(a) & set(b))
        return faults

    def check(self, answers=None) -> dict:
        """The comparison's numbers over the sample; ``answers`` replaces the
        program's (the control puts the reference in its place)."""
        picks = self.sample()
        got = self.program_answers(picks) if answers is None else answers(picks)
        ref = self.reference(picks, torch.float64)
        out = {}
        for k in ("text", "vision"):
            g, r = np.asarray(got[k], np.float64), ref[k]
            gap = np.linalg.norm(g - r, axis=1) / np.linalg.norm(r, axis=1)
            out[f"emb_gap_{k}"] = float(np.max(np.where(np.isfinite(gap), gap, np.inf)))
        out["pickle_faults"] = self.pickle_faults()
        out["sampled"] = len(picks)
        return out
