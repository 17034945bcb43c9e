"""Run cells of the benchmark in sets, one process at a time, and summarise
the spread of each metric.

    python3 portbench/sets.py --workloads sl-cv-null,wb-sweep --seeds 11,12,13 \
        --sets 2 --seconds 10 --trace 0 --out chiprun_out/sets.jsonl

Each run is ``python3 portbench/run.py`` as the benchmark's command gives
it; each set runs every seed once, in order, and every set the same seeds.
One JSON line a run (its result line, exit code, seconds and the end of its
standard error) is appended to ``--out``; the last line printed is the
summary: for each cell and metric the values of each set, their median and
their spread, the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_once(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cmd = bench["command"] + ["--workload", workload, "--seed", str(seed),
                              "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": time.time() - t0, "result": result, "stderr_tail": err[-8000:]}


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summarize(runs: list) -> dict:
    out = {}
    for r in runs:
        if r["result"] is None:
            continue
        cell = out.setdefault(r["workload"], {"correct": [], "sets": {}})
        cell["correct"].append(r["result"]["correct"])
        for name, m in r["result"]["metrics"].items():
            cell["sets"].setdefault(name, {}).setdefault(r["set"], []).append(m["value"])
    for cell in out.values():
        for name, sets in cell["sets"].items():
            cell["sets"][name] = {s: {"values": v, "median": statistics.median(v),
                                      "spread": spread(v)} for s, v in sets.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sets.jsonl"))
    args = ap.parse_args(argv)
    seconds = args.seconds or json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    runs = []
    for workload in args.workloads.split(","):
        for s in range(args.sets):
            for seed in seeds:
                r = run_once(workload, seed, seconds, args.trace, args.timeout)
                r["set"] = s
                runs.append(r)
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
                brief = r["result"] and {k: r["result"][k] for k in ("correct", "metrics",
                                                                     "checks")}
                print(json.dumps({"workload": workload, "set": s, "seed": seed, "rc": r["rc"],
                                  "wall_s": round(r["wall_s"], 1), "result": brief}),
                      flush=True)
                if r["rc"] != 0:
                    print(r["stderr_tail"][-1500:], flush=True)
    print(json.dumps(summarize(runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
