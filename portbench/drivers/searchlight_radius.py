"""Driver of the radius-mode searchlight cells: ``--radius`` in the place of
``--n-neighbors``, every neighbourhood a ball of the configuration's radius.

Set-up builds the adjacency as the CLI does, with the program's own
``io/surface.radius_adjacency`` on the device: each neighbourhood padded to
the largest count (Kmax) and a mask of its live columns.  The window calls
``run_searchlight`` with that mask, on the same chunks of whole blocks from
block 0 as the k-NN driver (``drivers/searchlight.py``, whose ``Driver``
this one extends), and records the launches of the panel kernel over the
window (``ops/hopper_solvers.launches``, counted on the card only).

The check holds the program's mask to a float64 ball of the radius on the
sampled vertices (``membership_misses``: the share of them whose live
columns differ from the ball by a neighbour farther from the radius than
float32 rounding of the squared distances explains), and its answers to
the plain reference fitted on exactly each ball's columns
(``reference/searchlight_radius.py``), over the sampled vertices whose live
columns are their ball (``ball_band_vertices`` counts the others: a
neighbour within that rounding of the radius, on one side in float32 and
on the other in float64).

Configuration keys: those of ``drivers/searchlight.py`` with ``radius`` in
the place of ``n_neighbors``.  Traffic keys: as there.  ``TINY_CONFIG``,
``TINY_TRAFFIC`` and ``FAULTS`` as there, with one fault more: an adjacency
whose live columns are not the ball, which has to fail ``membership_misses``
(``FAULT_NUMBERS``).
"""

from __future__ import annotations

import numpy as np

from portbench.harness import bench, judge
from portbench.reference import plain
from portbench.reference import searchlight_radius as reference

base = bench.module("drivers", "searchlight")

# a neighbour whose squared distance lies within this share of r^2 from r^2
# may fall on either side in float32 (|q|^2 - 2 q.p + |p|^2 at |q|^2 = 1e4)
BAND = 2e-5

TINY_CONFIG = dict({k: v for k, v in base.TINY_CONFIG.items() if k != "n_neighbors"},
                   radius=56.0)
TINY_TRAFFIC = base.TINY_TRAFFIC


def dropped_centre(fn):
    """A radius adjacency without each vertex's own column."""
    def adjacency(*a, **k):
        idx, mask, counts = fn(*a, **k)
        mask = mask.copy()
        mask[:, 0] = False
        return idx, mask, counts - 1
    return adjacency


SURFACE = "multimodal_decoding_tpu_torch.io.surface"
FAULTS = dict(base.FAULTS, membership=[(SURFACE, "radius_adjacency", dropped_centre)])
FAULT_NUMBERS = {"membership": "membership_misses"}


class Driver(base.Driver):
    def _adjacency(self, coords: np.ndarray) -> np.ndarray:
        from multimodal_decoding_tpu_torch.io.surface import radius_adjacency

        self.coords = coords
        idx, self.mask, _ = radius_adjacency(coords, self.cfg["radius"], device=self.device)
        return idx

    def window(self, seconds: float, *a, **k) -> dict:
        from multimodal_decoding_tpu_torch.ops import hopper_solvers

        start = hopper_solvers.launches
        rec = super().window(seconds, *a, **k)
        rec["panel_launches"] = hopper_solvers.launches - start
        return rec

    def reference(self, verts: np.ndarray, balls=None) -> dict:
        """The plain reference on ``balls`` (each vertex's float64 ball, worked
        out here where not given)."""
        tr = self.tr
        if balls is None:
            balls = reference.balls(self.coords, verts, self.cfg["radius"])
        return reference.vertices(
            self.X_all, balls, *self.reference_inputs(verts),
            alpha=tr.get("alpha"), alphas=tr.get("alphas"), n_splits=self.cfg["n_splits"],
            chunk=tr["reference_chunk"])

    def check(self, answers=None) -> dict:
        verts = self.sample()
        r2 = float(self.cfg["radius"]) ** 2
        balls = reference.balls(self.coords, verts, self.cfg["radius"])
        miss, same = [], []
        for v, ball in zip(verts, balls):
            live = self.adjacency[v][self.mask[v]]
            odd = np.array(sorted(set(live.tolist()) ^ set(ball.tolist())), dtype=np.int64)
            d2 = reference.squared_distances(self.coords, v, odd)
            miss.append(len(np.unique(live)) != len(live) or bool(np.any(
                np.abs(d2 - r2) > BAND * r2)))
            same.append(len(live) == len(ball) and not len(odd))
        same = np.array(same)
        got = self.program_answers(verts) if answers is None else answers(verts)
        ref = dict(self.reference(verts, balls), alphas=self.tr.get("alphas"))
        if same.any():
            numbers = judge.searchlight(
                rows(got, same), rows(ref, same),
                plain.comparisons(self.cfg["n_test"], self.cfg["n_imagery"]))
        else:
            numbers = {k: float("inf") for k in self.tr["limits"] if k != "membership_misses"}
        numbers["membership_misses"] = float(np.mean(miss))
        numbers["ball_band_vertices"] = int((~same).sum())
        return numbers


def rows(answers: dict, keep: np.ndarray) -> dict:
    """The sampled vertices ``keep`` of ``answers`` (alpha, cv, scores, null)."""
    out = dict(answers)
    for key in ("alpha", "cv"):
        if out.get(key) is not None:
            out[key] = np.asarray(out[key])[keep]
    for key in ("scores", "null"):
        out[key] = {m: np.asarray(a)[keep] for m, a in out[key].items()}
    return out
