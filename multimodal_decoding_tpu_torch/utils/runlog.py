"""Structured run logging (JSON-lines).

The reference's observability is print statements
(ridge_regression_decoding.py:163-187, searchlight.py:258-280).  This logger
keeps the prints but also appends machine-readable events to a .jsonl file
next to the results artifacts, giving every run a queryable record (config,
stage timings, scores, throughput).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, is_dataclass


class RunLogger:
    def __init__(self, path: str | None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def event(self, kind: str, **fields):
        record = {"t": time.time(), "kind": kind}
        for k, v in fields.items():
            if is_dataclass(v):
                v = asdict(v)
            record[k] = _jsonable(v)
        if self.echo:
            print(f"[{kind}] " + json.dumps({k: record[k] for k in fields}, default=str)[:500])
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record, default=str) + "\n")


def _jsonable(v):
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.tolist() if v.size <= 64 else f"<array {v.shape} {v.dtype}>"
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


def read_runlog(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
