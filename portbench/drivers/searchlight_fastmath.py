"""Driver of the 16-bit searchlight cells: the upstream searchlight's float16
deployment as the port runs it, with ``--fast-math``.

The window calls ``run_searchlight`` with the arguments the CLI passes under
``--fast-math`` (``decoding/searchlight.precision_arguments``: bf16 storage,
the fit and the predictions at ``"default"``, and the CV settings it maps
the traffic's grid to), the runner's own null gather, and ``X_all`` stored
in the dtype that mapping names, cast once at the warm-up call as the
runner casts the CLI's betas.  The chunks of whole blocks, the inputs and
the sample are those of ``drivers/searchlight.py``, whose ``Driver`` this
one extends.  The check holds the answers to the plain reference of the
16-bit contract (``reference/searchlight_fastmath.py``); its control,
``reference.OutputsInBf16``, runs through ``control_fastmath.py``.

Configuration keys: those of ``drivers/searchlight.py`` less ``precision``,
``cv_solver``, ``cv_scorer`` and ``null_gather``, with ``fast_math``.
Traffic keys: as there, with a fixed ``alpha``.  ``FAULTS`` as there, with
two more: the flag dropped (the step in float32 on float32 betas), and
every bf16 product's output rounded to bf16, a precision below the one
stated.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_decoding_tpu_torch.decoding import searchlight as program
from portbench.harness import bench
from portbench.reference import searchlight_fastmath as reference

base = bench.module("drivers", "searchlight")

TINY_CONFIG = base.TINY_CONFIG
TINY_TRAFFIC = base.TINY_TRAFFIC


def flag_dropped(fn):
    """The precision mapping with ``fast_math`` off."""
    def mapping(fast_math, *a, **k):
        return fn(False, *a, **k)
    return mapping


def outputs_in_bf16(fn):
    """A bf16 product whose output is rounded to bf16 as well."""
    def product(a, b):
        return fn(a, b).to(torch.bfloat16).to(torch.float32)
    return product


SEARCHLIGHT = "multimodal_decoding_tpu_torch.decoding.searchlight"
PRECISION = "multimodal_decoding_tpu_torch.ops.precision"
FAULTS = dict(base.FAULTS,
              float32=[(SEARCHLIGHT, "precision_arguments", flag_dropped)],
              outputs_in_bf16=[(PRECISION, "_rounded_product", outputs_in_bf16)])


class Driver(base.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.precision = program.precision_arguments(
            config["fast_math"], alphas_cv=traffic.get("alphas"), device=self.device)

    def _run(self, rows: slice, derangements):
        from multimodal_decoding_tpu_torch.parallel.searchlight_runner import run_searchlight

        cfg, tr = self.cfg, self.tr
        if self.X_all.dtype != self.precision["dtype"]:
            self.X_all = self.X_all.to(self.precision["dtype"])
        return run_searchlight(
            None, None, None, *self.Y_host, self.adjacency[rows], self.stim_types,
            alpha=tr["alpha"], alphas_cv=tr.get("alphas"), shuffles=self.shuffles,
            imagery_derangements=derangements, block_size=cfg["block_size"],
            device=self.device, progress=False, x_all_device=self.X_all,
            n_rows_split=(cfg["n_train"], cfg["n_test"], cfg["n_imagery"]), **self.precision)

    def reference(self, verts: np.ndarray) -> dict:
        return reference.vertices(
            self.X_all, torch.as_tensor(self.adjacency[verts], device=self.device),
            *self.reference_inputs(verts), alpha=self.tr["alpha"],
            chunk=self.tr["reference_chunk"])
