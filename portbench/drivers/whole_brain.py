"""Driver of the whole-brain cells: decodes over both hemispheres' features.

Set-up makes the betas in host memory (made on the device from the seed,
column block by column block, as the study holds them after loading) and the
latent sets.  An item is one decode, ``decoding/whole_brain.decode_single``
on a ``GramCache`` and the scores of its predictions: the inner loop of
``whole_brain.run`` without its file I/O.  Items take the traffic's
training modes in turn (each a contiguous range of the train rows), then
its latent sets.  With ``cold`` every item builds its own ``GramCache``, as
``run`` does for each new dataset; without it each mode's cache is built in
set-up and the window sweeps the latent sets over it, as ``run`` sweeps its
models.  The check runs the plain reference on a sample of the window's
decodes drawn from the seed, one of each training mode first.

Configuration keys: ``n_features``, ``n_train``, ``n_test``, ``n_imagery``,
``latent_dim``, ``mode_rows``, ``noise``, ``block_cols``, ``n_splits``,
``cv_solver``, ``cv_precision``.  Traffic keys: ``training_modes``,
``latent_noise``, ``alphas``, ``cold``, ``whole_cycles``,
``warmup_items``, ``sample``, ``limits``.

``TINY_CONFIG`` and ``TINY_TRAFFIC`` are the sizes the CPU tests shrink the
cells of this driver to; ``FAULTS`` names, for each fault the tests plant,
the program functions it wraps, as (module, function, planting helper): the
helpers are ``portbench/tests/faults.py``'s or this module's own.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.harness import bench, data, judge
from portbench.reference import whole_brain as reference
from portbench.tests.faults import stale

TINY_CONFIG = dict(n_features=3000, n_train=100, n_test=20, latent_dim=8, noise=2.0,
                   block_cols=512, mode_rows={"agnostic": [0, 100], "captions": [0, 50],
                                              "images": [50, 100]})
TINY_TRAFFIC = dict(sample=3)


def half_features(fn):
    """Gram kernels over the first half of the features, doubled (the mean
    over the rest)."""
    def kernels(X_train, queries=(), *a, **k):
        h = X_train.shape[1] // 2
        K, Kq = fn(X_train[:, :h], tuple(q[:, :h] for q in queries), *a, **k)
        return 2.0 * K, [2.0 * q for q in Kq]
    return kernels


def altered_prediction(fn):
    """A decode whose first test prediction is moved by 1."""
    def decode(*a, **k):
        alpha, test_preds, imag_preds, cv, fit_s = fn(*a, **k)
        test_preds = test_preds.copy()
        test_preds[0] += 1.0
        return alpha, test_preds, imag_preds, cv, fit_s
    return decode


WHOLE_BRAIN = "multimodal_decoding_tpu_torch.decoding.whole_brain"
FAULTS = {
    "state_unchanged": [(WHOLE_BRAIN, "decode_single", stale)],
    "half_batch": [(WHOLE_BRAIN, "streamed_kernels", half_features)],
    "answer_altered": [(WHOLE_BRAIN, "decode_single", altered_prediction)],
}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.modes = traffic["training_modes"]
        self.items: list = []
        self.setup_seconds: dict = {}

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache

        cfg, tr = self.cfg, self.tr
        phases = bench.Phases(self.device)
        gen = data.generator(self.seed, self.device)
        n_rows = (cfg["n_train"], cfg["n_test"], cfg["n_imagery"])
        (self.X_train, self.X_test, self.X_imag), Z = data.planted_betas_host(
            gen, n_rows, cfg["n_features"], cfg["latent_dim"], cfg["noise"],
            cfg["block_cols"], self.device)
        bounds = np.cumsum((0,) + n_rows)
        self.latents = []
        for noise in tr["latent_noise"]:
            Y = data.latent_set(gen, Z, noise, cfg["n_train"])
            self.latents.append([Y[a:b] for a, b in zip(bounds[:-1], bounds[1:])])
        del Z
        half = cfg["n_test"] // 2
        self.stim_types = np.array(["caption"] * half + ["image"] * (cfg["n_test"] - half))
        phases.mark("inputs")
        self.caches = {}
        if not tr["cold"]:
            for mode in self.modes:
                lo, hi = cfg["mode_rows"][mode]
                self.caches[mode] = GramCache(self.X_train[lo:hi], self.X_test, self.X_imag,
                                              device=self.device)
        phases.mark("grams")
        for i in range(tr["warmup_items"]):
            self._item(i)
        self.items = []
        phases.mark("warmup")
        self.setup_seconds = phases.seconds

    # -- the program --------------------------------------------------------

    def _which(self, i: int) -> tuple:
        return self.modes[i % len(self.modes)], (i // len(self.modes)) % len(self.latents)

    def _item(self, i: int, span=contextlib.nullcontext) -> dict:
        from multimodal_decoding_tpu_torch.decoding.whole_brain import GramCache, decode_single
        from multimodal_decoding_tpu_torch.ops import metrics as M

        cfg, tr = self.cfg, self.tr
        mode, s = self._which(i)
        lo, hi = cfg["mode_rows"][mode]
        X_tr = self.X_train[lo:hi]
        Y_tr, Y_te, Y_im = self.latents[s]
        Y_tr = Y_tr[lo:hi]
        gram_s = None
        if tr["cold"]:
            with span("portbench.gram"):
                cache = GramCache(X_tr, self.X_test, self.X_imag, device=self.device)
            gram_s = cache.gram_seconds
        else:
            cache = self.caches[mode]
        timings = {}
        with span("portbench.decode"):
            alpha, test_preds, imag_preds, cv_scores, _ = decode_single(
                X_tr, self.X_test, self.X_imag, Y_tr, Y_te, Y_im, tr["alphas"], cfg["n_splits"],
                gram_cache=cache, cv_solver=cfg["cv_solver"], device=self.device,
                timings=timings, cv_precision=cfg["cv_precision"])
        with span("portbench.scores"):
            scores = {k: float(v) for k, v in M.calc_all_pairwise_accuracy_scores(
                Y_te, test_preds, self.stim_types, Y_im, imag_preds,
                standardize_predictions=True, device=self.device).items()}
        return {"mode": mode, "set": s, "rows": hi - lo, "alpha": alpha,
                "cv_scores": np.asarray(cv_scores), "test_preds": test_preds,
                "imagery_preds": imag_preds, "scores": scores, "gram_s": gram_s,
                "cv_s": timings["cv_s"]}

    def window(self, seconds: float, span=contextlib.nullcontext) -> dict:
        """Items in turn until ``seconds`` have passed (and, with
        ``whole_cycles``, every training mode has had as many); returns the
        window's record."""
        cycle = len(self.modes) if self.tr["whole_cycles"] else 1
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        item_seconds = []
        while True:
            t_item = time.perf_counter()
            self.items.append(self._item(len(self.items), span))
            item_seconds.append(time.perf_counter() - t_item)
            if time.perf_counter() - t0 >= seconds and len(self.items) % cycle == 0:
                break
        rec = {"window_s": time.perf_counter() - t0, "decodes": len(self.items),
               "item_seconds": item_seconds,
               "gram_seconds": [it["gram_s"] for it in self.items if it["gram_s"] is not None],
               "gram_rows": [it["rows"] for it in self.items if it["gram_s"] is not None],
               "cv_seconds": [it["cv_s"] for it in self.items]}
        if self.device.type == "cuda":
            rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return rec

    def attempted_failed(self) -> tuple:
        bad = sum(not (np.all(np.isfinite(it["test_preds"]))
                       and np.all(np.isfinite(it["imagery_preds"]))) for it in self.items)
        return len(self.items), bad

    def release(self) -> None:
        """Drop the program's state (its kernels on the device) before the
        reference runs."""
        self.caches = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def sample(self) -> list:
        """Indices of the checked decodes: in an order drawn from the seed, the
        first of each training mode, then the next ones, ``sample`` in all."""
        order = data.rng(self.seed, data.STREAM_SAMPLE).permutation(len(self.items))
        first, seen = [], set()
        for i in order:
            if self.items[i]["mode"] not in seen:
                seen.add(self.items[i]["mode"])
                first.append(int(i))
        rest = [int(i) for i in order if int(i) not in first]
        return (first + rest)[:self.tr["sample"]]

    def reference(self, picks: list) -> list:
        cfg, dev = self.cfg, self.device
        K, (K_test, K_imag) = reference.kernels(self.X_train, [self.X_test, self.X_imag], dev,
                                                cfg["block_cols"])
        rows = torch.arange(cfg["n_test"], device=dev)
        half = cfg["n_test"] // 2
        out = []
        for i in picks:
            it = self.items[i]
            lo, hi = cfg["mode_rows"][it["mode"]]
            Y_tr, Y_te, Y_im = (torch.as_tensor(y, device=dev) for y in self.latents[it["set"]])
            out.append(reference.decode(
                K[lo:hi, lo:hi], K_test[:, lo:hi], K_imag[:, lo:hi], Y_tr[lo:hi], Y_te, Y_im,
                self.tr["alphas"], rows[:half], rows[half:], cfg["n_splits"]))
        return out

    def check(self, answers=None) -> dict:
        """The comparison's numbers over the sampled decodes; ``answers``
        replaces the program's (the control puts the reference in its place)."""
        picks = self.sample()
        got = [self.items[i] for i in picks] if answers is None else answers(picks)
        return judge.whole_brain(list(zip(got, self.reference(picks))))
