"""Driver of the searchlight cells: one hemisphere, vertex block by vertex block.

Set-up makes the hemisphere's mesh and its k-NN adjacency, the standardised
betas ``X_all`` on the device and the latents, all from the seed, and runs
one warm-up call, which also tells the block size: the configuration's
``block_size``, or with None (the CLI's default) the runner's own choice,
read from the call's ``aux``.  The window calls
``parallel/searchlight_runner.run_searchlight`` with ``x_all_device`` on
consecutive chunks of whole blocks of the adjacency, from block 0 on,
wrapping round at the hemisphere's end, as the CLI's one call over the
hemisphere runs them (without its checkpoint files).  The check runs the
plain reference on a sample of the window's vertices drawn from the seed.

Configuration keys: ``icosphere_subdivisions``, ``mesh_radius``,
``n_neighbors``, ``n_train``, ``n_test``, ``n_imagery``, ``latent_dim``,
``block_size`` (None: the runner's), ``n_splits``, ``signal_log10``,
``precision``, ``cv_solver``, ``cv_scorer``, ``null_gather``.  Traffic keys:
``alphas`` (the CV grid) or ``alpha``, ``n_permutations``,
``blocks_per_call``, ``sample``, ``reference_chunk``, ``limits``.

``TINY_CONFIG`` and ``TINY_TRAFFIC`` are the sizes the CPU tests shrink the
cells of this driver to; ``FAULTS`` names, for each fault the tests plant,
the program functions it wraps, as (module, function, planting helper): the
helpers are ``portbench/tests/faults.py``'s or this module's own.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from portbench.harness import bench, data, judge
from portbench.reference import plain
from portbench.reference import searchlight as reference
from portbench.tests.faults import stale

TINY_CONFIG = dict(icosphere_subdivisions=2, n_neighbors=12, n_train=60, n_test=20,
                   latent_dim=8, block_size=16, signal_log10=[-1.5, 0.0])
TINY_TRAFFIC = dict(n_permutations=5, blocks_per_call=2, sample=1000, reference_chunk=8)


def half_rows(fn):
    """A searchlight block step fitted on the first half of its train rows,
    their products doubled (the mean over the rest)."""
    def step(X_all, Y_train, *a, n_train, **k):
        h = n_train // 2
        X, Y = X_all.clone(), Y_train.clone()
        X[:h] *= math.sqrt(2.0)
        X[h:n_train] = 0.0
        Y[:h] *= math.sqrt(2.0)
        Y[h:] = 0.0
        return fn(X, Y, *a, n_train=n_train, **k)
    return step


def altered_vertex(fn):
    """A block step whose first vertex's caption accuracy is moved by 0.25."""
    def step(*a, **k):
        main, null = fn(*a, **k)
        main = dict(main)
        main["pairwise_acc_captions"] = main["pairwise_acc_captions"].clone()
        main["pairwise_acc_captions"][0] += 0.25
        return main, null
    return step


RUNNER = "multimodal_decoding_tpu_torch.parallel.searchlight_runner"
STEPS = ("searchlight_block_cv_with_null", "searchlight_block_with_null")
FAULTS = {
    "state_unchanged": [(RUNNER, s, stale) for s in STEPS],
    "half_batch": [(RUNNER, s, half_rows) for s in STEPS],
    "answer_altered": [(RUNNER, s, altered_vertex) for s in STEPS],
}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cv = "alphas" in traffic
        self.calls: list = []  # (first vertex, end vertex, scores, null, alpha) per window call
        self.setup_seconds: dict = {}
        self.mask = None  # [V, K] live neighbours, where the adjacency is padded

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        cfg, tr = self.cfg, self.tr
        phases = bench.Phases(self.device)
        coords = data.icosphere_coords(cfg["icosphere_subdivisions"], cfg["mesh_radius"])
        phases.mark("mesh")
        self.adjacency = self._adjacency(coords)
        self.n_vertices = len(coords)
        phases.mark("adjacency")
        gen = data.generator(self.seed, self.device)
        self.X_all, Y = data.planted_searchlight(
            gen, coords, cfg["n_train"], cfg["n_test"], cfg["n_imagery"], cfg["latent_dim"],
            tuple(cfg["signal_log10"]), self.device)
        self.Y = Y
        self.Y_host = [y.cpu().numpy() for y in Y]
        half = cfg["n_test"] // 2
        self.stim_types = np.array(["caption"] * half + ["image"] * (cfg["n_test"] - half))
        self.shuffles = data.within_modality_shuffles(
            data.rng(self.seed, data.STREAM_SHUFFLES), tr["n_permutations"], cfg["n_test"])
        phases.mark("inputs")
        # the warm-up: one block (vertex 0's, padded by the runner) of the
        # window's shapes, the runner's own imagery derangements
        self.B = self._run(slice(0, 1), None)[1]["block_size"]
        self.n_blocks = -(-self.n_vertices // self.B)
        self.block = 0
        phases.mark("warmup")
        self.setup_seconds = phases.seconds

    def _adjacency(self, coords: np.ndarray) -> np.ndarray:
        return data.knn_on_device(coords, self.cfg["n_neighbors"], self.device)

    # -- the program --------------------------------------------------------

    def _derangements(self, b0: int, nb: int) -> np.ndarray:
        return np.concatenate([data.derangement_choices(self.seed, b, self.B,
                                                        self.tr["n_permutations"])
                               for b in range(b0, b0 + nb)])

    def _run(self, rows: slice, derangements):
        """``run_searchlight`` over the vertices ``rows`` of the adjacency."""
        from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

        cfg, tr = self.cfg, self.tr
        n = cfg["n_train"], cfg["n_test"], cfg["n_imagery"]
        return run_searchlight(
            None, None, None, *self.Y_host, self.adjacency[rows], self.stim_types,
            alpha=tr.get("alpha", 1.0), alphas_cv=tr.get("alphas"),
            adjacency_mask=None if self.mask is None else self.mask[rows], shuffles=self.shuffles,
            imagery_derangements=derangements, block_size=cfg["block_size"],
            device=self.device, precision=cfg["precision"], cv_solver=cfg["cv_solver"],
            cv_scorer=cfg["cv_scorer"], null_gather=cfg["null_gather"], progress=False,
            x_all_device=self.X_all, n_rows_split=n)

    def _call(self, b0: int, nb: int):
        lo, hi = b0 * self.B, min((b0 + nb) * self.B, self.n_vertices)
        scores, aux = self._run(slice(lo, hi), self._derangements(b0, nb))
        if aux["block_size"] != self.B:
            raise RuntimeError(f"the runner's block size moved from {self.B} to "
                               f"{aux['block_size']} within one run")
        return lo, hi, scores, aux

    def window(self, seconds: float, span=contextlib.nullcontext) -> dict:
        """Calls on consecutive chunks until ``seconds`` have passed; returns
        the window's record (blocks, vertices, seconds, peak memory).
        ``span(name)`` wraps each call (the traced run's annotation)."""
        per_call = self.tr["blocks_per_call"]
        blocks = vertices = 0
        call_seconds = []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while True:
            nb = min(per_call, self.n_blocks - self.block)
            t_call = time.perf_counter()
            with span("portbench.run_searchlight"):
                lo, hi, scores, aux = self._call(self.block, nb)
            call_seconds.append(time.perf_counter() - t_call)
            self.calls.append((lo, hi, scores, aux["null_scores"], aux.get("best_alpha")))
            blocks += nb
            vertices += hi - lo
            self.block = (self.block + nb) % self.n_blocks
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        rec = {"window_s": window_s, "blocks": blocks, "vertices": vertices,
               "block_size": self.B, "call_seconds": call_seconds,
               "block_ids": [b for lo, hi, *_ in self.calls
                             for b in range(lo // self.B, -(-hi // self.B))]}
        if self.device.type == "cuda":
            rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return rec

    def attempted_failed(self) -> tuple:
        bad = sum(int(np.sum(~np.all([np.isfinite(s[m]) for m in s], axis=0)))
                  for _, _, s, _, _ in self.calls)
        return sum(hi - lo for lo, hi, *_ in self.calls), bad

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def program_answers(self, verts: np.ndarray) -> dict:
        """The window's answers at vertices ``verts`` (each from its latest call)."""
        where = {}
        for c, (lo, hi, *_rest) in enumerate(self.calls):
            for v in range(lo, hi):
                where[v] = (c, v - lo)
        picks = [where[v] for v in verts]

        def take(i, m):
            return np.array([self.calls[c][i][m][r] for c, r in picks])

        _, _, s0, n0, _ = self.calls[0]
        return {"alpha": (np.array([self.calls[c][4][r] for c, r in picks]) if self.cv else None),
                "scores": {m: take(2, m) for m in s0}, "null": {m: take(3, m) for m in n0}}

    def sample(self) -> np.ndarray:
        done = np.unique(np.concatenate([np.arange(lo, hi) for lo, hi, *_ in self.calls]))
        k = min(self.tr["sample"], len(done))
        return np.sort(data.rng(self.seed, data.STREAM_SAMPLE).choice(done, k, replace=False))

    def reference_inputs(self, verts: np.ndarray) -> tuple:
        """The plain reference's arguments after the neighbourhoods, for the
        vertices ``verts``: latents, test rows, shuffles, derangement choices."""
        dev = self.device
        rows = torch.arange(self.cfg["n_test"], device=dev)
        half = self.cfg["n_test"] // 2
        der = np.stack([data.derangement_choices(self.seed, v // self.B, self.B,
                                                 self.tr["n_permutations"])[v % self.B]
                        for v in verts])
        shuffles = torch.as_tensor(self.shuffles, device=dev).long()
        return *self.Y, rows[:half], rows[half:], shuffles, torch.as_tensor(der, device=dev)

    def reference(self, verts: np.ndarray) -> dict:
        cfg, tr = self.cfg, self.tr
        return reference.vertices(
            self.X_all, torch.as_tensor(self.adjacency[verts], device=self.device),
            *self.reference_inputs(verts), alpha=tr.get("alpha"), alphas=tr.get("alphas"),
            n_splits=cfg["n_splits"], chunk=tr["reference_chunk"])

    def check(self, answers=None) -> dict:
        """The comparison's numbers over the sample; ``answers`` replaces the
        program's (the control puts the reference in its place)."""
        verts = self.sample()
        got = self.program_answers(verts) if answers is None else answers(verts)
        ref = dict(self.reference(verts), alphas=self.tr.get("alphas"))
        return judge.searchlight(got, ref,
                                 plain.comparisons(self.cfg["n_test"], self.cfg["n_imagery"]))
