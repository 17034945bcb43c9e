"""Readings behind the limits of a cell's correctness check, in one process.

    python3 portbench/control.py --workload sl-cv-null --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 3 --out chiprun_out/control.jsonl

For each seed: the cell's set-up and a short window of the program, then
the comparison's numbers of the program against the plain reference (the
lower readings of the limits); for the control seeds also the numbers of the
control, the plain reference computed in the nearest precision below the
configuration's (float32 products in TF32) and put in the program's place
(the upper readings).  The benchmark's own runs never run the control.  One
JSON line a seed.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench.harness import bench, judge  # noqa: E402


@contextlib.contextmanager
def tf32():
    """cuBLAS and cuDNN float32 products in TF32, restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def readings(workload: str, seed: int, seconds: float, control: bool, device="cuda") -> dict:
    """The program's numbers (and the control's) on one seed."""
    cell = bench.cell(workload)
    drv = bench.module("drivers", cell.traffic["driver"]).Driver(cell.config, cell.traffic,
                                                                 seed, device)
    drv.setup()
    drv.window(seconds)
    drv.release()
    out = {"workload": workload, "seed": seed, "program": drv.check()}
    if control:
        def answers(picks):
            with tf32():
                return drv.reference(picks)
        out["control"] = drv.check(answers)
    limits = cell.traffic["limits"]
    out["program_correct"] = judge.verdict(out["program"], limits)[0]
    if control:
        out["control_correct"] = judge.verdict(out["control"], limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        r = readings(args.workload, seed, args.seconds, seed in controls)
        r["seconds"] = time.time() - t0
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
