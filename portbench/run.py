"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``portbench/configs/<config>.json``) and a traffic
mix (``portbench/traffic/<traffic>.json``), whose ``driver``
(``portbench/drivers/<driver>.py``) makes the inputs from the seed, runs
the program's set-up and warm-up, then its measured window of ``--seconds``,
and after the window the plain reference over a sample of the answers.
The metrics are read by ``portbench/metrics/<reader>.py`` (a metric named
``<reader>.<group>`` is one quantity split among cells): the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1`` (``torch.profiler`` over the window).  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are its last key and the last lines of standard error.

Exits with another code than 0, and prints no result, without as many CUDA
devices as the cell asks for, when the program cannot be imported, or when
JAX or the JAX package was loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import bench, judge  # noqa: E402
from portbench.harness.trace import WINDOW_SPAN, Tracer  # noqa: E402


@dataclass
class Context:
    """What a metric's reader reads."""

    setup_s: float
    record: dict
    trace: dict | None
    config: dict
    traffic: dict
    driver: object

    @staticmethod
    def counts(name: str):
        return bench.counts(name)


def card_state(fields: str) -> str | None:
    """``nvidia-smi``'s reading of ``fields`` on the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def read_metrics(entries: list, ctx: Context) -> dict:
    out = {}
    for m in entries:
        value = bench.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_imports = time.perf_counter() - T0
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_context = time.perf_counter() - T0 - t_imports

    driver = bench.module("drivers", cell.traffic["driver"]).Driver(
        cell.config, cell.traffic, args.seed, "cuda")
    driver.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    setup_peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"setup_phases": dict({"imports": t_imports, "cuda_context": t_context},
                                           **driver.setup_seconds)}), file=sys.stderr)

    tracer = Tracer(bool(args.trace))
    with tracer.profiling():
        with tracer.span(WINDOW_SPAN):
            record = driver.window(args.seconds, tracer.span)
    card = card_state("name,power.limit")
    print(f"card: {card}; after the window: "
          f"{card_state('clocks.sm,temperature.gpu,power.draw')}", file=sys.stderr)
    trace = tracer.summary()
    peak = max(setup_peak, record.get("peak_window_bytes", 0))

    loaded = bench.forbidden_loaded(sys.modules)
    if loaded:
        print(f"forbidden modules loaded in the run's process: {loaded}", file=sys.stderr)
        return 3
    if args.trace and trace is None:
        print("the profiler recorded no window", file=sys.stderr)
        return 4

    ctx = Context(setup_s, record, trace, cell.config, cell.traffic, driver)
    metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end, ctx)
    attempted, failed = driver.attempted_failed()
    tracer.prof = None
    driver.release()

    t_check = time.perf_counter()
    numbers = driver.check()
    correct, checks = judge.verdict(numbers, cell.traffic["limits"])
    correct = correct and attempted > 0 and failed == 0
    print(json.dumps({"numbers": numbers, "check_s": time.perf_counter() - t_check,
                      "record": {k: v for k, v in record.items() if k != "block_ids"},
                      "trace_events": trace and trace["events"],
                      "trace_spans": trace and trace["spans"]}), file=sys.stderr)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(peak), "card": card}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device}
    if trace is not None:
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
