"""What one run of the benchmark reads: BENCHMARK.json, a cell's configuration
and traffic files, and the per-cell modules found by name.

Everything that belongs to one configuration, traffic mix, metric or count
lives in a file of its own under ``portbench/``:

* ``configs/<config>.json``: the deployment's sizes, ``source``,
  ``assumed`` and ``reduced``;
* ``traffic/<traffic>.json``: the mix's parameters, the ``driver`` that
  runs it (``drivers/<driver>.py``) and the limits of its correctness check;
* ``metrics/<metric>.py``: a reader ``read(ctx)`` that returns the metric's
  value, or None where the run has nothing for it to read.  A metric named
  ``<metric>.<group>`` is the same quantity split among cells that report
  different end-to-end metrics or hold different bounds, and is read by
  ``metrics/<metric>.py``;
* ``counts/<name>.py``: the least work of a step, term by term.

Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# whole top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multimodal_decoding_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


_modules: dict = {}


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded once by its path."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if path not in _modules:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def counts(name: str):
    return module("counts", name)


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric before its first dot>.py``."""
    return module("metrics", metric.split(".", 1)[0])


@dataclass
class Cell:
    """One entry of ``workloads``, with its configuration and traffic files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json metric entries
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[0]
    return Cell(name=name, chips=int(w["chips"]), config=config(w["config"]),
                traffic=traffic(w["traffic"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def forbidden_loaded(modules) -> list:
    """The names in ``modules`` whose top-level name (before the first dot) is
    one of FORBIDDEN_MODULES, compared whole: ``multimodal_decoding_tpu_torch``
    is not ``multimodal_decoding_tpu``."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)


class Phases:
    """Seconds of each named phase of a run's set-up on the host's clock,
    each ended by a device synchronisation: ``mark(name)`` ends the phase
    ``name`` that began at the previous mark."""

    def __init__(self, device=None):
        self.device, self.t, self.seconds = device, time.perf_counter(), {}

    def mark(self, name: str) -> None:
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
