"""Driver of the searchlight CLI's host path: one hemisphere's run outside
the searchlight's blocks.

Set-up makes, from the seed, what the CLI reads for one subject, mode and
hemisphere, under a fresh directory: the betas caches as
``data/betas.get_fmri_surface_data`` writes them (``np.savez``,
uncompressed, float32, at the paths ``surface_cache_path`` gives), NaN on a
medial-wall cap in every train row, the stim-info pickles and the model's
latents pickle, and points the program's data paths there.  It builds the
program's ``SearchlightConfig`` through the CLI's own ``main`` (its mesh
loader handed the benchmark's mesh, its ``run`` held back) and loads, or on
a checkout's first run builds, the 750-NN adjacency through the program's
``build_adjacency`` into the adjacency cache, which lies at a fixed path in
the checkout (``.work/adjacency_cache``), as a study's runs share one.  The
warm-up streams the test and imagery caches to the card and loads the
latents, so the window's first call finds the pinned buffers, the device
allocation and the latents' cache as later calls do.

Each window call is one call of the program's ``decoding/searchlight.run``
with that configuration, one look-up replaced: ``run_searchlight``, the
runner, by a stand-in that runs no block (the other sl cells time the
blocks).  The stand-in keeps only the sampled entries of ``X_all`` and the
adjacency it was handed, and returns the runner's output contract at full
size (the configuration's ``runner_outputs``, made in set-up from the
seed), so ``run`` writes its real files.  The calls of
``streamed_scaler_fit``, ``streamed_x_all_device`` and ``build_adjacency``
(looked up in ``decoding/searchlight``) and of ``artifacts.save_pickle`` and
``save_null_scores_npz`` are timed on the host's clock, and the process's
resident memory is sampled every ``rss_interval_s`` through each call.

The check, after the window, against ``reference/ingest.py``: ``x_gap``, the
widest gap of the sampled ``X_all`` entries of any call from the float64
reference over its largest magnitude; ``kept_mismatch``, columns whose kept
state differs from the cap (in the mask the call used, the width of its
``X_all`` and of its adjacency); ``adjacency_misses``, the share of sampled
vertices whose neighbours are not an exact 750-NN; ``results_faults``, the
last call's results pickle and ``null_distr.npz``, read back with ``pickle``
and ``np.load``, against the schema and against what the call used and
returned.  The control (``control.py``'s TF32 switch): the reference with its
statistics accumulated in float32 and ``X_all`` rounded to bfloat16.

Configuration keys: ``subject``, ``training_mode``, ``hemi``, ``model``,
``icosphere_subdivisions``, ``mesh_radius``, ``n_neighbors``, ``n_train``,
``n_test``, ``n_imagery``, ``latent_dim``, ``l2_regularization_alpha``,
``create_null_distr``, ``n_permutations_per_subject``, ``stream_ingest``,
``medial_wall_share``, ``beta_offset_sd``, ``beta_log_scale_sd``,
``runner_outputs``.  Traffic keys: ``sample_train_rows``,
``sample_test_rows``, ``sample_columns``, ``sample_vertices``,
``score_sample``, ``tie_tolerance``, ``rss_interval_s``, ``limits``.
``TINY_CONFIG``, ``TINY_TRAFFIC`` and ``FAULTS`` as in
``drivers/searchlight.py``; the tiny caches are far under the 2 GiB at which
``--stream-ingest auto`` streams, so the tiny cell streams by ``on``.
"""

from __future__ import annotations

import contextlib
import glob
import math
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

from portbench.harness import bench, data
from portbench.reference import ingest as reference

WORK = os.path.join(bench.BENCH_DIR, ".work")
ADJACENCY_CACHE = os.path.join(WORK, "adjacency_cache")
PAGE_CACHE = ("the betas caches were written in set-up and are read from the page cache "
              "(the machine's caches are not dropped): the calls time the host's work, "
              "not the disk")

TINY_CONFIG = dict(icosphere_subdivisions=2, n_neighbors=12, n_train=48, latent_dim=8,
                   n_permutations_per_subject=5, stream_ingest="on")
TINY_TRAFFIC = dict(sample_train_rows=16, sample_test_rows=8, sample_columns=64,
                    sample_vertices=32, score_sample=32)

SEARCHLIGHT = "multimodal_decoding_tpu_torch.decoding.searchlight"
ARTIFACTS = "multimodal_decoding_tpu_torch.io.artifacts"


# -- faults the CPU tests plant (portbench/tests) ---------------------------


class _Rows:
    """The rows of ``readers`` one after the other, the first ``n_rows`` of
    them, as one reader (what ``streamed_scaler_fit`` reads)."""

    def __init__(self, readers: list, n_rows: int | None = None):
        self.readers = readers
        self.n_rows = sum(r.n_rows for r in readers) if n_rows is None else n_rows
        self.n_cols, self.dtype = readers[0].n_cols, readers[0].dtype

    def iter_row_chunks(self, chunk_rows: int, buf=None):
        offset = 0
        for r in self.readers:
            for row0, view in r.iter_row_chunks(chunk_rows, buf):
                if offset + row0 >= self.n_rows:
                    return
                yield offset + row0, view[:self.n_rows - offset - row0]
            offset += r.n_rows


def _test_cache(reader):
    """The test split's cache beside the train cache ``reader`` reads."""
    return type(reader)(glob.glob(os.path.join(os.path.dirname(reader.path),
                                               "surf_*_test_*.npz"))[0])


def unfitted(fn):
    """The scaler returns its state unchanged: mean 0, scale 1."""
    def fit(reader, keep, *a, **k):
        n = int(np.sum(keep))
        return np.zeros(n, np.float32), np.ones(n, np.float32)
    return fit


def half_train_rows(fn):
    """The statistics over the first half of the train rows."""
    def fit(reader, keep, *a, **k):
        return fn(_Rows([reader], reader.n_rows // 2), keep, *a, **k)
    return fit


def train_and_test_rows(fn):
    """The statistics over the train rows and the test rows."""
    def fit(reader, keep, *a, **k):
        return fn(_Rows([reader, _test_cache(reader)]), keep, *a, **k)
    return fit


def ddof_one(fn):
    """The sample standard deviation (ddof 1) for the population's."""
    def fit(reader, keep, *a, **k):
        mean, scale = fn(reader, keep, *a, **k)
        n = reader.n_rows
        return mean, (scale * np.float32(math.sqrt(n / (n - 1)))).astype(np.float32)
    return fit


def mask_from_test_row(cls):
    """Readers whose first train row is the test split's first row: the NaN
    mask taken from a test row."""
    class Reader(cls):
        def read_row(self, i):
            if "_train_" in os.path.basename(self.path):
                return cls.read_row(_test_cache(self), i)
            return super().read_row(i)
    return Reader


def kept_column_dropped(fn):
    """``X_all`` without the first kept column."""
    def upload(readers, keep, mean32, scale32, *a, **k):
        keep = np.array(keep, dtype=bool)
        keep[np.flatnonzero(keep)[0]] = False
        return fn(readers, keep, mean32[1:], scale32[1:], *a, **k)
    return upload


def x_all_bf16(fn):
    """``X_all`` stored in bfloat16."""
    def upload(*a, **k):
        return fn(*a, **dict(k, dtype=torch.bfloat16))
    return upload


def unfiltered_adjacency(fn):
    """The adjacency of all the mesh's vertices, the NaN ones among them."""
    def build(coords, nan_locations=None, *a, **k):
        return fn(coords, None, *a, **k)
    return build


def altered_score(fn):
    """The results pickle with the first score of its first map raised by 0.25."""
    def save(obj, path):
        maps = dict(obj["score_maps"])
        first = next(iter(maps))
        maps[first] = maps[first].copy()
        maps[first][0] += 0.25
        return fn(dict(obj, score_maps=maps), path)
    return save


FAULTS = {
    "state_unchanged": [(SEARCHLIGHT, "streamed_scaler_fit", unfitted)],
    "half_batch": [(SEARCHLIGHT, "streamed_scaler_fit", half_train_rows)],
    "answer_altered": [(ARTIFACTS, "save_pickle", altered_score)],
    "train_and_test_rows": [(SEARCHLIGHT, "streamed_scaler_fit", train_and_test_rows)],
    "ddof_one": [(SEARCHLIGHT, "streamed_scaler_fit", ddof_one)],
    "mask_from_test_row": [(SEARCHLIGHT, "NpzMemberReader", mask_from_test_row)],
    "kept_column_dropped": [(SEARCHLIGHT, "streamed_x_all_device", kept_column_dropped)],
    "x_all_bf16": [(SEARCHLIGHT, "streamed_x_all_device", x_all_bf16)],
    "unfiltered_adjacency": [(SEARCHLIGHT, "build_adjacency", unfiltered_adjacency)],
}
FAULT_NUMBERS = {
    "state_unchanged": "x_gap", "half_batch": "x_gap", "answer_altered": "results_faults",
    "train_and_test_rows": "x_gap", "ddof_one": "x_gap", "mask_from_test_row": "kept_mismatch",
    "kept_column_dropped": "kept_mismatch", "x_all_bf16": "x_gap",
    "unfiltered_adjacency": "adjacency_misses",
}


# -- the driver ---------------------------------------------------------------


@contextlib.contextmanager
def replaced(module, name: str, make):
    """``module.name`` replaced by ``make(module.name)`` for the block."""
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def medial_wall(coords: np.ndarray, share: float) -> np.ndarray:
    """[V] bool: the cap of ``share`` of the vertices farthest along +x."""
    x = coords[:, 0].astype(np.float64) / np.linalg.norm(coords, axis=1)
    cap = np.zeros(len(coords), dtype=bool)
    cap[np.argsort(-x, kind="stable")[:int(round(share * len(coords)))]] = True
    return cap


def resident_bytes() -> int | None:
    """This process's resident memory (Linux), or None."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class ResidentPeak:
    """The most the resident memory rises above its value at the start of the
    block, sampled every ``interval`` seconds by a thread (None where it
    cannot be read)."""

    def __init__(self, interval: float):
        self.interval, self.rise = interval, None
        self._stop = threading.Event()

    def _sample(self):
        while not self._stop.wait(self.interval):
            now = resident_bytes()
            self._peak = max(self._peak, now)

    def __enter__(self):
        self._start = self._peak = resident_bytes()
        if self._start is not None:
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._start is not None:
            self._stop.set()
            self._thread.join()
            self.rise = max(self._peak, resident_bytes()) - self._start
        return False


def cpu_model() -> str | None:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


class Call:
    """What one window call of ``run`` did; the arrays only of the latest."""

    def __init__(self):
        self.seconds = 0.0
        # host seconds in the timed functions (None: not called)
        self.scaler_s = self.upload_s = self.adjacency_s = None
        self.pickle_s = self.nulls_s = None  # the results pickle, null_distr.npz
        self.upload_bytes, self.readers = 0, 0
        self.host_rise = None  # bytes the resident memory rose
        self.reached = self.streamed = False  # the stand-in called, with x_all_device
        self.x = self.x_width = None  # the sampled entries of X_all, its width
        self.inputs = {}
        self.nan_locations = None  # the mask build_adjacency was given
        self.built = None  # what build_adjacency returned
        self.adjacency = self.adjacency_rows = None  # what the stand-in was handed
        self.maps = self.nulls = None  # what it returned
        self.results = None  # the results pickle's path
        self.results_bytes = 0  # of the files the call wrote

    @property
    def write_s(self):
        parts = [s for s in (self.pickle_s, self.nulls_s) if s is not None]
        return sum(parts) if parts else None

    def timed(self, attr: str, fn, after=None):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            setattr(self, attr, (getattr(self, attr) or 0.0) + time.perf_counter() - t0)
            if after is not None:
                after(out, *a, **k)
            return out
        return call

    def light(self) -> None:
        self.adjacency = self.built = self.maps = self.nulls = None


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.setup_seconds: dict = {}
        self.calls: list = []
        self.workdir = None
        self._paths_saved: dict = {}

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        cfg = self.cfg
        phases = bench.Phases(self.device)
        self.coords = data.icosphere_coords(cfg["icosphere_subdivisions"], cfg["mesh_radius"])
        self.kept = ~medial_wall(self.coords, cfg["medial_wall_share"])
        self.n_kept = int(self.kept.sum())
        phases.mark("mesh")
        os.makedirs(WORK, exist_ok=True)
        self.workdir = tempfile.mkdtemp(prefix="sl-cli-ingest-", dir=WORK)
        weakref.finalize(self, shutil.rmtree, self.workdir, True)
        gen = data.generator(self.seed, self.device)
        self._point_program_paths()
        self.caches = self._write_betas(gen)
        phases.mark("caches")
        self._write_latents(gen)
        phases.mark("latents")
        self.pcfg = self._cli_config()
        with contextlib.redirect_stdout(sys.stderr):
            from multimodal_decoding_tpu_torch.decoding import searchlight

            searchlight.build_adjacency(self.coords, ~self.kept, None, cfg["n_neighbors"],
                                        cache_dir=self.pcfg.adjacency_cache_dir,
                                        device=self.device)
        phases.mark("adjacency")
        self._draw_sample()
        self._runner_outputs(gen)
        phases.mark("outputs")
        self._warm_up()
        phases.mark("warmup")
        self.setup_seconds = phases.seconds

    def _point_program_paths(self) -> None:
        """The program's data paths into the fresh directory (restored at
        ``release``)."""
        from multimodal_decoding_tpu_torch import config as pc

        where = {"BETAS_CACHE_DIR": "betas_cache", "FMRI_STIM_INFO_DIR": "stim_info",
                 "LATENT_FEATURES_DIR": "nn_features"}
        for attr, sub in where.items():
            self._paths_saved[attr] = getattr(pc, attr)
            setattr(pc, attr, os.path.join(self.workdir, sub))
            os.makedirs(getattr(pc, attr), exist_ok=True)

    def _write_betas(self, gen: torch.Generator) -> dict:
        """Each split's betas cache, made on the device in row blocks; returns
        {split: (path, bytes)}."""
        from multimodal_decoding_tpu_torch.config import CAPTION, IMAGE, IMAGERY
        from multimodal_decoding_tpu_torch.data.betas import surface_cache_path
        from multimodal_decoding_tpu_torch.data.stimuli import IMAGERY_STIMS_IDS, TEST_STIM_IDS

        cfg = self.cfg
        v = len(self.coords)
        offset = torch.randn(v, generator=gen, device=self.device).mul_(cfg["beta_offset_sd"])
        scale = torch.randn(v, generator=gen, device=self.device).mul_(
            cfg["beta_log_scale_sd"]).exp_()
        cap = torch.as_tensor(~self.kept, device=self.device)
        n_train = cfg["n_train"]
        order = data.rng(self.seed, data.STREAM_SHUFFLES).permutation(n_train)
        self.train_ids = (1_000_000 + order // 2).astype(np.int64)
        self.train_types = np.where(order % 2 == 0, CAPTION, IMAGE)
        half = len(TEST_STIM_IDS) // 2
        splits = {
            "train": (n_train, self.train_ids, self.train_types, cfg["training_mode"]),
            "test": (cfg["n_test"], np.asarray(TEST_STIM_IDS),
                     np.array([IMAGE] * half + [CAPTION] * half), None),
            "imagery": (cfg["n_imagery"], np.asarray(IMAGERY_STIMS_IDS[cfg["subject"]]),
                        np.array([IMAGERY] * cfg["n_imagery"]), None),
        }
        block = max(1, (256 << 20) // (4 * v))
        out = {}
        betas_dir = os.path.join(self.workdir, "betas")
        for split, (rows, ids, types, mode) in splits.items():
            host = np.empty((rows, v), dtype=np.float32)
            for r0 in range(0, rows, block):
                r1 = min(rows, r0 + block)
                x = torch.randn((r1 - r0, v), generator=gen, device=self.device)
                x.mul_(scale).add_(offset)
                if split == "train":
                    x[:, cap] = float("nan")
                torch.from_numpy(host[r0:r1]).copy_(x)
            kw = {} if mode is None else {"mode": mode}
            path = surface_cache_path(betas_dir, cfg["subject"], split, hemi=cfg["hemi"], **kw)
            np.savez(path, betas=host, stim_ids=ids, stim_types=types)
            out[split] = (path, os.path.getsize(path))
            del host
        self.betas_dir = betas_dir
        return out

    def _write_latents(self, gen: torch.Generator) -> None:
        """The stim-info pickles and the model's latents pickle."""
        from multimodal_decoding_tpu_torch import config as pc
        from multimodal_decoding_tpu_torch.data.stimuli import IMAGERY_STIMS_IDS, TEST_STIM_IDS

        cfg, subject = self.cfg, self.cfg["subject"]
        for what, values in (("ids", self.train_ids), ("types", self.train_types)):
            with open(os.path.join(pc.FMRI_STIM_INFO_DIR,
                                   f"{subject}_stim_{what}_train.p"), "wb") as f:
                pickle.dump(values, f)
        ids = np.unique(np.concatenate([self.train_ids, np.asarray(TEST_STIM_IDS),
                                        np.asarray(IMAGERY_STIMS_IDS[subject])]))
        keys = (pc.VISION_CLS_FEAT_KEY, pc.VISION_MEAN_FEAT_KEY, pc.LANG_CLS_FEAT_KEY,
                pc.LANG_MEAN_FEAT_KEY)
        vectors = torch.randn((len(ids), len(keys), cfg["latent_dim"]), generator=gen,
                              device=self.device).cpu().numpy()
        feats = {int(i): {key: vectors[j, n] for n, key in enumerate(keys)}
                 for j, i in enumerate(ids)}
        with open(pc.model_features_file_path(cfg["model"]), "wb") as f:
            pickle.dump(feats, f)

    def _cli_config(self):
        """The ``SearchlightConfig`` the CLI builds from its arguments."""
        from multimodal_decoding_tpu_torch.cli import run_searchlight as cli

        cfg = self.cfg
        argv = ["--betas-dir", self.betas_dir, "--subjects", cfg["subject"],
                "--training-modes", cfg["training_mode"], "--model", cfg["model"],
                "--hemis", cfg["hemi"], "--n-neighbors", str(cfg["n_neighbors"]),
                "--l2-regularization-alpha", repr(cfg["l2_regularization_alpha"]),
                "--n-permutations-per-subject", str(cfg["n_permutations_per_subject"]),
                "--mesh-dir", os.path.join(self.workdir, "surfaces"),
                "--out-dir", os.path.join(self.workdir, "searchlight"),
                "--adjacency-cache-dir", ADJACENCY_CACHE, "--overwrite",
                "--stream-ingest", cfg["stream_ingest"], "--device", self.device.type]
        if cfg["create_null_distr"]:
            argv.append("--create-null-distr")
        held = {}

        def mesh(load):
            def coords(mesh_dir, resolution, hemis):
                return {h: self.coords for h in hemis}
            return coords

        def hold(run):
            def take(pcfg):
                held["cfg"] = pcfg
                return []
            return take

        with replaced(cli, "load_mesh_coords", mesh), replaced(cli, "run", hold):
            cli.main(argv)
        return held["cfg"]

    def _draw_sample(self) -> None:
        cfg, tr = self.cfg, self.tr
        r = data.rng(self.seed, data.STREAM_SAMPLE)
        n_train, n_test = cfg["n_train"], cfg["n_test"]
        self.rows = np.sort(np.concatenate([
            r.choice(n_train, min(tr["sample_train_rows"], n_train), replace=False),
            n_train + r.choice(n_test, min(tr["sample_test_rows"], n_test), replace=False),
            n_train + n_test + np.arange(cfg["n_imagery"])]))
        self.columns = np.sort(r.choice(self.n_kept, min(tr["sample_columns"], self.n_kept),
                                        replace=False))
        self.vertices = np.sort(r.choice(self.n_kept, min(tr["sample_vertices"], self.n_kept),
                                         replace=False))
        self.score_vertices = np.sort(r.choice(self.n_kept, min(tr["score_sample"],
                                                                self.n_kept), replace=False))
        self.rows_d = torch.as_tensor(self.rows, device=self.device)
        self.columns_d = torch.as_tensor(self.columns, device=self.device)

    def _runner_outputs(self, gen: torch.Generator) -> None:
        """The stand-in's answers at V' kept vertices: each accuracy a count
        over its comparisons, main around 0.55 and nulls around 0.5."""
        outputs, p = self.cfg["runner_outputs"], self.cfg["n_permutations_per_subject"]

        def accuracies(n, shape, mean):
            k = torch.randn(shape, generator=gen, device=self.device)
            k.mul_(math.sqrt(n * mean * (1 - mean))).add_(n * mean).round_().clamp_(0, n)
            return k.div_(n).cpu().numpy()

        self.maps = {m: accuracies(n, (self.n_kept,), 0.55) for m, n in outputs["main"].items()}
        self.nulls = ({m: accuracies(outputs["main"][m], (self.n_kept, p), 0.5)
                       for m in outputs["null"]} if self.cfg["create_null_distr"] else None)

    def _warm_up(self) -> None:
        """The test and imagery caches streamed to the device, an ``X_all``-sized
        allocation, the latents' pickle cached: the first call of ``run`` finds
        what later ones find."""
        from multimodal_decoding_tpu_torch.config import LatentFeatsConfig
        from multimodal_decoding_tpu_torch.data.features import get_latent_features
        from multimodal_decoding_tpu_torch.parallel import ingest

        cfg = self.cfg
        readers = [ingest.NpzMemberReader(self.caches[s][0]) for s in ("test", "imagery")]
        keep = self.kept
        mean, scale = ingest.streamed_scaler_fit(readers[0], keep)
        x = ingest.streamed_x_all_device(readers, keep, mean, scale, device=self.device)
        n_rows = cfg["n_train"] + cfg["n_test"] + cfg["n_imagery"]
        del x
        x = torch.empty((n_rows, self.n_kept), dtype=torch.float32, device=self.device)
        del x
        get_latent_features(LatentFeatsConfig(cfg["model"], verbose=False), cfg["subject"],
                            "train", cfg["training_mode"])

    # -- the program --------------------------------------------------------

    def _x_entries(self, call: Call, x_all_device, host_splits) -> None:
        cols = self.columns
        if x_all_device is not None:
            width = x_all_device.shape[1]
            ok = cols < width
            c = self.columns_d if ok.all() else self.columns_d[torch.as_tensor(ok)]
            picked = x_all_device.index_select(0, self.rows_d).index_select(1, c)
            picked = picked.to(torch.float32).cpu().numpy()
        else:
            bounds = np.cumsum([0] + [len(s) for s in host_splits])
            width = host_splits[0].shape[1]
            ok = cols < width
            split = np.searchsorted(bounds, self.rows, side="right") - 1
            picked = np.stack([host_splits[s][r - bounds[s]] for r, s in zip(self.rows, split)])
            picked = picked[:, cols[ok]].astype(np.float32)
        out = np.full((len(self.rows), len(cols)), np.nan, dtype=np.float32)
        out[:, ok] = picked
        call.x, call.x_width = out, width

    def _stand_in(self, call: Call):
        """The runner's place: no block; the output contract at full size."""
        def run_searchlight(X_train, X_test, X_imag, Y_train, Y_test, Y_imag, adjacency,
                            stim_types_test, alpha=1.0, alphas_cv=None, adjacency_mask=None,
                            shuffles=None, x_all_device=None, n_rows_split=None, **kw):
            t0 = time.perf_counter()
            call.reached, call.streamed = True, x_all_device is not None
            self._x_entries(call, x_all_device, (X_train, X_test, X_imag))
            call.adjacency, call.adjacency_rows = adjacency, len(adjacency)
            call.inputs = {"Y": [list(np.shape(y)) for y in (Y_train, Y_test, Y_imag)],
                           "adjacency": list(np.shape(adjacency)), "alpha": alpha,
                           "shuffles": None if shuffles is None else list(np.shape(shuffles)),
                           "n_rows_split": None if n_rows_split is None else list(n_rows_split)}
            v = len(adjacency)
            maps, nulls = self.maps, self.nulls
            if v != self.n_kept:  # a program at fault: answers of its own width
                maps = {m: np.resize(a, v) for m, a in maps.items()}
                nulls = nulls and {m: np.resize(a, (v, a.shape[1])) for m, a in nulls.items()}
            call.maps, call.nulls = maps, nulls
            elapsed = time.perf_counter() - t0
            aux = {"elapsed_s": elapsed, "vertices_per_sec": v / max(elapsed, 1e-9),
                   "block_size": None, "n_blocks": 0}
            if shuffles is not None:
                aux["null_scores"] = nulls
            return dict(maps), aux
        return run_searchlight

    def _call(self) -> Call:
        """One call of the program's ``decoding/searchlight.run``."""
        from multimodal_decoding_tpu_torch.decoding import searchlight
        from multimodal_decoding_tpu_torch.io import artifacts

        call = Call()
        depth = [0]

        def adjacency_built(out, coords, nan_locations=None, *a, **k):
            call.nan_locations = None if nan_locations is None else np.array(nan_locations)
            call.built = out

        def adjacency(fn):
            def build(*a, **k):
                depth[0] += 1
                try:
                    if depth[0] > 1:  # the cache's own call on a miss
                        return fn(*a, **k)
                    return call.timed("adjacency_s", fn, adjacency_built)(*a, **k)
                finally:
                    depth[0] -= 1
            return build

        def uploaded(out, readers, *a, **k):
            call.readers = len(readers)
            call.upload_bytes += out.shape[0] * out.shape[1] * 4  # float32 rows cross

        with replaced(searchlight, "run_searchlight", lambda fn: self._stand_in(call)), \
                replaced(searchlight, "streamed_scaler_fit",
                         lambda fn: call.timed("scaler_s", fn)), \
                replaced(searchlight, "streamed_x_all_device",
                         lambda fn: call.timed("upload_s", fn, uploaded)), \
                replaced(searchlight, "build_adjacency", adjacency), \
                replaced(artifacts, "save_pickle", lambda fn: call.timed("pickle_s", fn)), \
                replaced(artifacts, "save_null_scores_npz",
                         lambda fn: call.timed("nulls_s", fn)), \
                contextlib.redirect_stdout(sys.stderr), \
                ResidentPeak(self.tr["rss_interval_s"]) as rss:
            outputs = searchlight.run(self.pcfg)
        call.host_rise = rss.rise
        call.results = outputs[-1] if outputs else None
        if call.results is not None:
            folder = os.path.dirname(call.results)
            call.results_bytes = sum(os.path.getsize(os.path.join(folder, f))
                                     for f in os.listdir(folder))
        return call

    def window(self, seconds: float, span=contextlib.nullcontext) -> dict:
        """Calls of ``run`` until ``seconds`` have passed; returns the window's
        record.  ``span(name)`` wraps each call."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        calls = []
        t0 = time.perf_counter()
        while True:
            t_call = time.perf_counter()
            with span("portbench.cli_run"):
                call = self._call()
            call.seconds = time.perf_counter() - t_call
            if self.calls:
                self.calls[-1].light()
            self.calls.append(call)
            calls.append(call)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        rec = {"window_s": window_s, "calls": len(calls),
               "call_seconds": [c.seconds for c in calls],
               "scaler_s": [c.scaler_s for c in calls], "upload_s": [c.upload_s for c in calls],
               "upload_bytes": [c.upload_bytes for c in calls],
               "adjacency_s": [c.adjacency_s for c in calls],
               "write_s": [c.write_s for c in calls], "pickle_s": [c.pickle_s for c in calls],
               "null_npz_s": [c.nulls_s for c in calls],
               "results_bytes": [c.results_bytes for c in calls],
               "host_rise_bytes": [c.host_rise for c in calls],
               "streamed": [c.streamed for c in calls], "readers": [c.readers for c in calls],
               "x_all_columns": [c.x_width for c in calls], "n_kept": self.n_kept,
               "runner_inputs": calls[-1].inputs,
               "cache_bytes": {s: b for s, (_, b) in self.caches.items()},
               "cpu_model": cpu_model(), "cpu_count": os.cpu_count(),
               "cpu_affinity": len(os.sched_getaffinity(0)),
               "page_cache": PAGE_CACHE}
        if self.device.type == "cuda":
            rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return rec

    def attempted_failed(self) -> tuple:
        failed = sum(not c.reached or c.results is None for c in self.calls)
        return len(self.calls), failed

    def release(self) -> None:
        """Drop the program's device state and give the program its data
        paths back (the caches and the last call's files stay for the check)."""
        from multimodal_decoding_tpu_torch import config as pc

        for attr, value in self._paths_saved.items():
            setattr(pc, attr, value)
        self._paths_saved = {}
        self.rows_d = self.columns_d = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def _paths(self) -> tuple:
        return tuple(self.caches[s][0] for s in ("train", "test", "imagery"))

    def reference(self, sample) -> dict:
        """The reference's ``X_all`` entries at ``sample`` = (rows, columns);
        under ``control.py``'s switch (TF32 allowed) one precision down: the
        statistics accumulated in float32, the result rounded to bfloat16."""
        low = bool(torch.backends.cuda.matmul.allow_tf32)
        rows, columns = sample
        return {"x": reference.entries(self._paths(), self.kept, rows, columns, low)}

    def _kept_mismatch(self, call: Call, saved_mask) -> int:
        mask = call.nan_locations if call.nan_locations is not None else saved_mask
        cap = ~self.kept
        if mask is None or np.shape(mask) != cap.shape:
            faults = len(cap)
        else:
            faults = int(np.sum(np.asarray(mask, dtype=bool) != cap))
        for width in (call.x_width, call.adjacency_rows):
            faults += self.n_kept if width is None else abs(width - self.n_kept)
        return faults

    def _results_faults(self, call: Call, results, nulls: dict) -> int:
        cfg = self.cfg
        outputs = cfg["runner_outputs"]
        faults = reference.schema_faults(
            results, nulls, len(self.coords), self.n_kept, cfg["n_neighbors"],
            list(outputs["main"]), list(outputs["null"]) if cfg["create_null_distr"] else [],
            cfg["n_permutations_per_subject"])
        if not isinstance(results, dict):
            return faults

        def differs(a, b):
            return a is None or b is None or np.shape(a) != np.shape(b) or not np.array_equal(
                np.asarray(a), np.asarray(b))

        faults += differs(results.get("nan_locations"), call.nan_locations)
        faults += differs(results.get("adjacency"), call.adjacency)
        faults += differs(results.get("distances"), None if call.built is None else call.built[3])
        if "score_maps" in results:  # the port's own copy of the scores, where it keeps one
            faults += sum(differs(results["score_maps"].get(m), a)
                          for m, a in (call.maps or {}).items())
        scores = results.get("scores")
        for v in self.score_vertices:
            entry = scores[v] if scores is not None and v < len(scores) else None
            faults += not isinstance(entry, dict) or any(
                differs(entry.get(m), a[v]) for m, a in (call.maps or {}).items())
        faults += sum(differs(nulls.get(m), a) for m, a in (call.nulls or {}).items())
        return int(faults)

    def check(self, answers=None) -> dict:
        """The comparison's numbers; ``answers`` replaces the program's
        ``X_all`` entries (the control puts the reference in its place)."""
        sample = (self.rows, self.columns)
        truth = reference.entries(self._paths(), self.kept, self.rows, self.columns)
        got = [c.x for c in self.calls] if answers is None else [answers(sample)["x"]]
        top = float(np.abs(truth).max())
        gaps = [np.abs(np.asarray(g, dtype=np.float64) - truth) for g in got if g is not None]
        x_gap = max((float(np.where(np.isfinite(g), g, np.inf).max()) for g in gaps),
                    default=float("inf")) / top
        last = self.calls[-1]
        results, nulls = None, {}
        if last.results is not None and os.path.isfile(last.results):
            with open(last.results, "rb") as f:
                results = pickle.load(f)
            path = os.path.join(os.path.dirname(last.results), "null_distr.npz")
            if os.path.isfile(path):
                with np.load(path, allow_pickle=False) as z:
                    nulls = {k: z[k] for k in z.files}
        saved_mask = results.get("nan_locations") if isinstance(results, dict) else None
        adjacency = last.adjacency
        return {
            "x_gap": x_gap,
            "kept_mismatch": max(self._kept_mismatch(c, saved_mask) for c in self.calls),
            "adjacency_misses": 1.0 if adjacency is None else reference.neighbour_misses(
                self.coords, self.kept, adjacency, self.vertices, self.cfg["n_neighbors"],
                self.tr["tie_tolerance"]),
            "results_faults": self._results_faults(last, results, nulls),
            "calls": len(self.calls),
            "sampled_entries": int(truth.size),
        }
