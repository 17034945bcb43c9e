"""How much of a tensor-core count's time is the first operand's layout.

Times ``streamed_acc_from_factors`` and ``streamed_acc_from_inv`` of the port
in the tree given by ``--tree`` at "default" and "high", with a bf16
first operand ``Xv_b [B, nv, K]`` (the main path's shapes, B = 128, nv =
1639, K = 750) in two layouts holding the same values:

    view     the transposed view of [nv, B, K] fold patches (a vertex stride
             of K x 2 = 1500 bytes), as a tree that does not pad them hands
             it over
    padded   the same patches in rows of 64 elements (128 bytes), as the
             engine lays them out for the fused streamed scorers

Run for two trees in turns (e.g. an unpacked earlier commit and this one)
on one card, the difference between the layouts on the earlier tree is
what the layout alone gives its kernel, and the difference between the trees
on the padded layout what the kernel gives.  The accuracies of the two
layouts must be equal bit for bit.  One JSON line per (kernel, precision,
layout) with its CUDA-event median ms (10 samples after 2 warm-ups); the
card's name and power limit first.  Needs a CUDA device and nvcc:

    python3 tools/first_operand_layout.py --tree <root of a checkout> --label <name>
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, NV, K = 128, 1639, 750


def padded_rows(x, dtype):
    """``x`` in ``dtype`` in a view whose rows start 128 bytes apart."""
    import torch

    ld = -(-x.shape[-1] // 64) * 64
    out = torch.empty((*x.shape[:-1], ld), dtype=dtype, device=x.device)[..., :x.shape[-1]]
    return out.copy_(x)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[reps // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="root of the checkout whose port is timed (default: this one)")
    ap.add_argument("--label", default="this", help="name of the tree in the output")
    ap.add_argument("--seed", type=int, default=22)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    if not torch.cuda.is_available():
        raise SystemExit("first_operand_layout: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    patches = torch.randn((NV, B, K), generator=gen, device="cuda")
    layouts = {"view": patches.to(torch.bfloat16).permute(1, 0, 2),
               "padded": padded_rows(patches, torch.bfloat16).permute(1, 0, 2)}
    del patches
    Z = HM.padded_empty(B, K, NV, "cuda").copy_(torch.randn((B, K, NV), generator=gen,
                                                            device="cuda"))
    inv = torch.randn((B, K, K), generator=gen, device="cuda") / K
    calls = {"streamed_acc_from_factors": lambda xv, p: HM.streamed_acc_from_factors(xv, Z, p),
             "streamed_acc_from_inv": lambda xv, p: HM.streamed_acc_from_inv(xv, inv, Z, p)}
    for name, call in calls.items():
        for precision in ("default", "high"):
            accs = {lay: call(xv, precision) for lay, xv in layouts.items()}
            torch.cuda.synchronize()
            equal = bool(torch.equal(accs["view"], accs["padded"]))
            for lay, xv in layouts.items():
                print(json.dumps({"tree": args.label, "kernel": name, "precision": precision,
                                  "layout": lay, "ms": median_ms(lambda: call(xv, precision)),
                                  "layouts_equal": equal}), flush=True)
            if not equal:
                raise AssertionError(f"{args.label} {name} at {precision}: the two layouts "
                                     f"give different accuracies")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
