"""Driver of the group-statistics cells: the study's group-level permutation
null, both hemispheres, through the program's own loop.

Set-up makes both hemispheres' meshes and edges (``harness/surface.py``) and
every subject's within-subject null maps of each member metric on the
device, all from the seed: Gaussian noise on the sphere one level below the
mesh, smoothed there by ``smoothing_iterations`` rounds of averaging each
vertex with its neighbours (a searchlight map is smooth over the width of a
patch), carried up to the mesh by the midpoints that make it, scaled to
``null_spread`` around the member's chance level, and NaN on a cap of
``medial_wall_share`` of the vertices that stands for the medial wall.  Then
one warm-up call of one chunk.

The window calls the program's ``decoding/permutation.null_max_tfce_statistics``
on the next ``perms_per_call`` of the deployment's group permutations (the
program's own ``ops/stats.group_permutations`` over all of them, taken in
set-up), from permutation 0 on, wrapping round at the last: the program's
loop over hemispheres and chunks, its t-maps on the device, its copy to
pinned memory, its TFCE on the host and its maxima.  Two of the program's
look-ups are handed the benchmark's inputs for the call: the null stacks,
which the CLI reads from the searchlights' files
(``permutation._stacked_null_scores``), and the call's rows of the
permutations (``stats.group_permutations``); the function that caches the
result is given a fresh directory and its file is removed after each call.
``ops/tfce.tfce_map`` is timed (host seconds and maps), and the t-maps it
receives at ``T_GAP_ROWS`` of the sampled permutations are copied.

The check draws, from the seed, ``sample`` of the permutations the window
ran, and holds the program's maximum of each to the plain reference
(``reference/group.py``) from the same null maps in float64.  TFCE only
grows where its map grows, so the reference brackets the answer: TFCE of
the float64 t-map lowered, and raised, by ``t_tolerance`` (relative, at
least 1 absolute).  ``null_max_gap`` is the widest distance of a program
maximum outside its bracket, over the bracket's top (at least 1); a
program whose t-maps are within the tolerance lands inside, whatever
threshold a vertex sits on.  ``t_gap`` (no limit: it reads the program's
t-maps through ``tfce_map``, which a program that runs TFCE elsewhere would
not call) is the widest relative gap of the copied t-maps from the float64
ones, inf where their NaN patterns differ: the reading ``t_tolerance`` is set
above.

The control: ``control.py`` runs the reference in the program's place with
float32 products in TF32, the precision below float32 for products.  This
reference has no products; under that switch it rounds the null maps to
bfloat16, the precision below float32 for its elementwise work, the storage
a later change would be tempted by.

Configuration keys: ``icosphere_subdivisions``, ``mesh_radius``,
``hemis``, ``n_subjects``, ``n_permutations_per_subject``,
``n_permutations_group_level``, ``n_neighbors`` (the searchlights'),
``metric``, ``members`` {name: chance
level}, ``tfce_h``, ``tfce_e``, ``tfce_dh``, ``null_chunk``,
``null_spread``, ``smoothing_iterations``, ``medial_wall_share``.  Traffic
keys: ``perms_per_call``, ``sample``, ``t_tolerance``, ``limits``.
``TINY_CONFIG``, ``TINY_TRAFFIC`` and ``FAULTS`` as in
``drivers/searchlight.py``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.harness import bench, data, surface
from portbench.reference import group as reference
from portbench.tests.faults import stale

TINY_CONFIG = dict(icosphere_subdivisions=3, n_permutations_per_subject=8,
                   n_permutations_group_level=24, null_chunk=4, smoothing_iterations=2)
TINY_TRAFFIC = dict(perms_per_call=12, sample=24)


def half_subjects(fn):
    """The gather of a chunk that keeps the first half of the subjects: the
    t-maps are taken over the rest."""
    def gather(scores, permutations):
        out = fn(scores, permutations)
        return out[:, :out.shape[1] // 2]
    return gather


def first_subject_dropped(fn):
    def gather(scores, permutations):
        return fn(scores, permutations)[:, 1:]
    return gather


def popmean_off(fn):
    """Every member's chance level 0.01 too high."""
    def sweep(stacks, permutations, popmeans):
        return fn(stacks, permutations, [p + 0.01 for p in popmeans])
    return sweep


def other_hemisphere(fn):
    """TFCE over the other hemisphere's edges: vertex v of one is V - 1 - v of
    the other (``harness/surface.hemispheres``)."""
    def tfce_map(values, edges, *a, **k):
        return fn(values, np.asarray(values).shape[-1] - 1 - np.asarray(edges), *a, **k)
    return tfce_map


def altered_max(fn):
    """A chunk whose first permutation's maximum is raised by a quarter and 1."""
    def largest(maps):
        out = fn(maps).copy()
        out[0] = out[0] * 1.25 + 1.0
        return out
    return largest


PERMUTATION = "multimodal_decoding_tpu_torch.decoding.permutation"
STATS = "multimodal_decoding_tpu_torch.ops.stats"
TFCE = "multimodal_decoding_tpu_torch.ops.tfce"
FAULTS = {
    "state_unchanged": [(STATS, "null_min_t_maps", stale)],
    "half_batch": [(STATS, "_gather", half_subjects)],
    "answer_altered": [(PERMUTATION, "_max_ignoring_nan", altered_max)],
    "subject_dropped": [(STATS, "_gather", first_subject_dropped)],
    "popmean_off": [(STATS, "null_min_t_maps", popmean_off)],
    "other_hemisphere_edges": [(TFCE, "tfce_map", other_hemisphere)],
}
FAULT_NUMBERS = {f: "null_max_gap" for f in FAULTS}
T_GAP_ROWS = 8  # sampled permutations whose t-maps the window copies for t_gap


@contextlib.contextmanager
def replaced(module, name: str, make):
    """``module.name`` replaced by ``make(module.name)`` for the block."""
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def smooth_fields(gen: torch.Generator, parents: np.ndarray, n_coarse: int,
                  iterations: int, n_fields: int, device) -> torch.Tensor:
    """[V, n_fields] float32: Gaussian noise on the ``n_coarse`` vertices of
    the level below, each round of ``iterations`` the mean of every vertex
    and its neighbours there (``parents`` are that level's edges), then each
    vertex of the mesh's last level the mean of the edge it halves."""
    table = torch.as_tensor(surface.neighbour_table(parents, n_coarse), device=device)
    x = torch.randn((n_coarse, n_fields), generator=gen, device=device)
    acc, tmp = torch.empty_like(x), torch.empty_like(x)
    for _ in range(iterations):
        torch.index_select(x, 0, table[:, 0], out=acc)
        for j in range(1, table.shape[1]):
            torch.index_select(x, 0, table[:, j], out=tmp)
            acc.add_(tmp)
        x, acc = acc.div_(table.shape[1]), x
    del acc, tmp
    p = torch.as_tensor(parents, device=device)
    return torch.cat([x, (x[p[:, 0]] + x[p[:, 1]]).mul_(0.5)])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.setup_seconds: dict = {}
        self.calls: list = []  # (rows, null_max) per window call
        self.tfce_s, self.tfce_maps = 0.0, 0
        self.kept: dict = {}  # {hemi: {row: program t-map}} at t_gap's rows
        self.wanted: set = set()

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        cfg = self.cfg
        phases = bench.Phases(self.device)
        mesh = surface.hemispheres(cfg["icosphere_subdivisions"], cfg["mesh_radius"])
        self.hemis = list(cfg["hemis"])
        self.edges = {h: (mesh[h]["edges"], mesh[h]["lengths"]) for h in self.hemis}
        coords = mesh["left"]["coords"]
        self.n_vertices = v = len(coords)
        phases.mark("mesh")
        self.members = list(cfg["members"])
        self.popmeans = [float(cfg["members"][m]) for m in self.members]
        n_subj, p_within = cfg["n_subjects"], cfg["n_permutations_per_subject"]
        # the medial wall: the cap of the left hemisphere's vertices farthest along +x
        # (towards the midline), the same vertices mirrored in the right
        x = coords[:, 0].astype(np.float64) / np.linalg.norm(coords, axis=1)
        cap = np.argsort(-x, kind="stable")[:int(round(cfg["medial_wall_share"] * v))]
        gen = data.generator(self.seed, self.device)
        self.stacks = {}
        n_fields = len(self.members) * n_subj * p_within
        for h in self.hemis:
            field = smooth_fields(gen, mesh["parents"], v - len(mesh["parents"]),
                                  cfg["smoothing_iterations"], n_fields, self.device)
            field.div_(field.std())
            if h == "right":
                field = field.flip(0)
            wall = torch.as_tensor(cap if h == "left" else v - 1 - cap, device=self.device)
            field[wall] = float("nan")
            maps = field.T.contiguous().view(len(self.members), n_subj, p_within, v)
            del field
            self.stacks[h] = {m: maps[i].mul_(cfg["null_spread"]).add_(chance)
                              for i, (m, chance) in enumerate(zip(self.members, self.popmeans))}
        phases.mark("null_maps")
        from multimodal_decoding_tpu_torch.ops import stats

        self.total = cfg["n_permutations_group_level"]
        self.program_perms = stats.group_permutations(p_within, n_subj, self.total)
        self.keys = data.rng(self.seed, data.STREAM_SAMPLE).random(self.total)
        self.workdir = tempfile.mkdtemp(prefix="portbench-group-")
        self.pcfg = self._program_config()
        phases.mark("permutations")
        self._call(np.arange(min(cfg["null_chunk"], self.total)))  # the warm-up: one chunk
        self.calls, self.kept = [], {h: {} for h in self.hemis}
        self.tfce_s, self.tfce_maps = 0.0, 0
        self.next_row = 0
        phases.mark("warmup")
        self.setup_seconds = phases.seconds

    def _program_config(self):
        from multimodal_decoding_tpu_torch.decoding.permutation import PermutationConfig

        cfg = self.cfg
        return PermutationConfig(
            subjects=[f"sub-{i + 1:02d}" for i in range(cfg["n_subjects"])],
            n_neighbors=cfg["n_neighbors"], metric=cfg["metric"], tfce_h=cfg["tfce_h"],
            tfce_e=cfg["tfce_e"], tfce_dh=cfg["tfce_dh"], hemis=self.hemis,
            edges_by_hemi=self.edges, out_dir=self.workdir, null_chunk=cfg["null_chunk"],
            device=str(self.device))

    # -- the program --------------------------------------------------------

    def _call(self, rows: np.ndarray) -> np.ndarray:
        """``null_max_tfce_statistics`` over the group permutations ``rows``."""
        from multimodal_decoding_tpu_torch.decoding import permutation
        from multimodal_decoding_tpu_torch.ops import stats, tfce

        n = len(rows)
        seen = [0]

        def stacks(make):
            def stacked(cfg, hemi, members, mesh=None):
                return {m: self.stacks[hemi][m] for m in members}
            return stacked

        def permutations(make):
            def chosen(n_within, n_subjects, n_group):
                asked = (n_within, n_subjects, n_group)
                if asked != (self.cfg["n_permutations_per_subject"], self.cfg["n_subjects"], n):
                    raise ValueError(f"group permutations {asked} asked for, not the call's")
                return self.program_perms[rows]
            return chosen

        def timed(fn):
            def tfce_map(values, *a, **k):
                t0 = time.perf_counter()
                out = fn(values, *a, **k)
                self.tfce_s += time.perf_counter() - t0
                maps = np.atleast_2d(np.asarray(values))
                self._keep(maps, rows, seen[0], n)
                seen[0] += len(maps)
                self.tfce_maps += len(maps)
                return out
            return tfce_map

        if self.kept:  # t_gap's candidates: the least keys of every row run so far
            self.wanted = set(self.sample(rows)[:T_GAP_ROWS].tolist())
            for kept in self.kept.values():
                for row in set(kept) - self.wanted:
                    del kept[row]
        self.pcfg.n_permutations_group_level = n
        with replaced(permutation, "_stacked_null_scores", stacks), \
                replaced(stats, "group_permutations", permutations), \
                replaced(tfce, "tfce_map", timed):
            out = permutation.null_max_tfce_statistics(self.pcfg)["null_max"]
        os.remove(os.path.join(permutation.permutation_results_dir(self.pcfg),
                               f"null_max{permutation.get_hparam_suffix(self.pcfg)}.npz"))
        return np.asarray(out)

    def _keep(self, maps: np.ndarray, rows: np.ndarray, first: int, n: int) -> None:
        """Copy the t-maps of the rows that may be sampled (the program's loop
        takes the hemispheres in turn, each over the call's rows in order)."""
        for i, j in enumerate(range(first, first + len(maps))):
            row = int(rows[j % n])
            if row in self.wanted:
                self.kept[self.hemis[j // n]][row] = maps[i].copy()

    def window(self, seconds: float, span=contextlib.nullcontext) -> dict:
        """Calls on the next rows until ``seconds`` have passed; returns the
        window's record.  ``span(name)`` wraps each call."""
        per_call = self.tr["perms_per_call"]
        call_seconds = []
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        while True:
            rows = (self.next_row + np.arange(per_call)) % self.total
            t_call = time.perf_counter()
            with span("portbench.group_null"):
                out = self._call(rows)
            call_seconds.append(time.perf_counter() - t_call)
            self.calls.append((rows, out))
            self.next_row = int((self.next_row + per_call) % self.total)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        chunk = self.cfg["null_chunk"]
        starts = range(0, per_call, chunk)
        sizes = [min(chunk, per_call - s) for s in starts]
        rec = {"window_s": window_s, "calls": len(self.calls),
               "perms": per_call * len(self.calls), "call_seconds": call_seconds,
               "chunks": len(self.calls) * len(self.hemis) * len(sizes),
               "tfce_s": self.tfce_s, "tfce_maps": self.tfce_maps,
               "tfce_threads": os.environ.get("MMD_TFCE_THREADS") or "all hardware threads",
               "cpu_count": os.cpu_count(), "cpu_affinity": len(os.sched_getaffinity(0)),
               "sweep_chunks": [[c, self._distinct(rows[s:s + c])] for _ in self.hemis
                                for rows, _ in self.calls for s, c in zip(starts, sizes)]}
        if self.device.type == "cuda":
            rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(self.device)
        return rec

    def _distinct(self, rows: np.ndarray) -> int:
        """Distinct (subject, within-subject map) pairs the permutations ``rows`` gather."""
        perms = self.program_perms[rows]
        return int(sum(len(np.unique(perms[:, s])) for s in range(perms.shape[1])))

    def attempted_failed(self) -> tuple:
        answers = np.concatenate([out for _, out in self.calls])
        return len(answers), int(np.sum(~np.isfinite(answers)))

    def release(self) -> None:
        """Drop the program's state before the reference runs (the null maps
        are the benchmark's inputs and stay)."""
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------

    def sample(self, *more: np.ndarray) -> np.ndarray:
        """The ``sample`` rows of least key among those the window's calls (and
        ``more``) ran, the least key first."""
        done = np.unique(np.concatenate([rows for rows, _ in self.calls] + list(more)))
        return done[np.argsort(self.keys[done], kind="stable")[:self.tr["sample"]]]

    def program_answers(self, rows: np.ndarray) -> dict:
        """The window's maximum at each of ``rows`` (from its latest call)."""
        latest = {}
        for call_rows, out in self.calls:
            latest.update(zip(call_rows.tolist(), out.tolist()))
        return {"null_max": np.array([latest[int(r)] for r in rows])}

    def _t_maps(self, row: int, bf16: bool = False) -> dict:
        """{hemi: float64 [V] reference t-map} of group permutation ``row``."""
        cfg = self.cfg
        perm = torch.as_tensor(reference.permutation(
            int(row), cfg["n_permutations_per_subject"], cfg["n_subjects"]), device=self.device)
        subjects = torch.arange(cfg["n_subjects"], device=self.device)
        out = {}
        for h in self.hemis:
            picked = [self.stacks[h][m][subjects, perm] for m in self.members]
            if bf16:
                picked = [x.to(torch.bfloat16) for x in picked]
            out[h] = reference.t_min(picked, self.popmeans)
        return out

    def _largest(self, maps: dict, edges: dict) -> float:
        cfg = self.cfg
        return max(reference.largest(reference.tfce(maps[h], edges[h], cfg["tfce_h"],
                                                    cfg["tfce_e"], cfg["tfce_dh"]))
                   for h in self.hemis)

    def _edges(self) -> dict:
        return {h: torch.as_tensor(self.edges[h][0], device=self.device) for h in self.hemis}

    def reference(self, rows: np.ndarray) -> dict:
        """The reference's own maxima at ``rows``; under ``control.py``'s switch
        (TF32 allowed) from null maps rounded to bfloat16."""
        bf16 = bool(torch.backends.cuda.matmul.allow_tf32)
        edges = self._edges()
        return {"null_max": np.array([self._largest(self._t_maps(r, bf16), edges)
                                      for r in rows])}

    def check(self, answers=None) -> dict:
        """The comparison's numbers over the sample; ``answers`` replaces the
        program's (the control puts the reference in its place)."""
        rows = self.sample()
        got = (self.program_answers(rows) if answers is None else answers(rows))["null_max"]
        edges, tol = self._edges(), self.tr["t_tolerance"]
        gaps, t_gaps = [], []
        for row, p in zip(rows, got):
            t = self._t_maps(row)
            room = {h: tol * torch.clamp(t[h].abs(), min=1.0) for h in self.hemis}
            lo = self._largest({h: t[h] - room[h] for h in self.hemis}, edges)
            hi = self._largest({h: t[h] + room[h] for h in self.hemis}, edges)
            gaps.append(max(lo - p, p - hi, 0.0) / max(abs(hi), 1.0) if np.isfinite(p)
                        else float("inf"))
            for h in self.hemis:
                if int(row) in self.kept.get(h, {}):
                    t_gaps.append(t_gap(self.kept[h][int(row)], t[h].cpu().numpy()))
        numbers = {"null_max_gap": float(max(gaps)), "sampled": len(rows)}
        if t_gaps and answers is None:
            numbers["t_gap"] = float(max(t_gaps))
        return numbers


def t_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """Widest gap of a t-map from the float64 one, relative (at least 1
    absolute); inf where the NaN patterns differ."""
    got = np.asarray(got, dtype=np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(ref)):
        return float("inf")
    ok = ~np.isnan(ref)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(got[ok] - ref[ok]) / np.maximum(np.abs(ref[ok]), 1.0)))
