"""Where the panel kernel's time goes: SM cycles between its block barriers.

Builds an instrumented copy of ``csrc/chol_inv_panel.cu``: thread 0 of block
0 reads ``clock64()`` at the kernel's start, after every ``__syncthreads()``
and at its end.  For each panel size it prints one JSON line with the
kernel's CUDA-event time (one batch of 200 launches after 100 of warm-up,
B = 128 grams of 8192 rows plus 100 I), the total cycles of block 0 and the
cycles of each interval between barriers: the load and first leaf, then
steps A and B of each panel in turn (see the kernel's source note), then the
last panel's store.  Run on a machine with a CUDA device and nvcc:

    python -m multimodal_decoding_tpu_torch.utils.panel_cycles [--pb 188 187 64]

The instrumented library goes to ``_build/``; nothing else is changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

from multimodal_decoding_tpu_torch.ops import _cuda_build

MAX_STAMPS = 63  # prof[63] holds the number of stamps
_STAMP = "if (threadIdx.x == 0 && blockIdx.x == 0) prof[n_stamps++] = clock64();"


def instrument(source: str) -> str:
    """``chol_inv_panel.cu`` with clock64() stamps at the kernel's barriers.

    The kernel and ``chol_inv_panel_launch`` gain a last argument, a device
    pointer to ``MAX_STAMPS + 1`` int64 values.
    """
    head = ("chol_inv_panel_kernel(const float* __restrict__ a, float* __restrict__ out, "
            "int n, int ld) {")
    launch = "int pb, void* stream) {"
    call = "static_cast<float*>(out), pb, ld);"
    for part in (head, launch, call):
        if source.count(part) != 1:
            raise ValueError(f"chol_inv_panel.cu no longer has {part!r} once")
    start = source.index(head)
    end = source.index("}  // namespace", start)
    body = source[start + len(head):end].replace("__syncthreads();", "__syncthreads(); " + _STAMP)
    close = body.rindex("}")
    body = (body[:close] + "  __syncthreads(); " + _STAMP
            + f"\n  if (threadIdx.x == 0 && blockIdx.x == 0) prof[{MAX_STAMPS}] = n_stamps;\n"
            + body[close:])
    kernel = (head[:-3] + ", long long* prof) {\n  int n_stamps = 0;\n  " + _STAMP + body)
    tail = (source[end:].replace(launch, "int pb, void* stream, void* prof) {")
            .replace(call, "static_cast<float*>(out), pb, ld, static_cast<long long*>(prof));"))
    return source[:start] + kernel + tail


def build() -> str:
    """Compile the instrumented kernel into ``_build/``; returns the library path."""
    with open(os.path.join(_cuda_build.CSRC_DIR, "chol_inv_panel.cu")) as f:
        source = instrument(f.read())
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_cuda_build.BUILD_DIR, "chol_inv_panel_cycles.cu")
    lib = os.path.join(_cuda_build.BUILD_DIR, "libchol_inv_panel_cycles.so")
    with open(src, "w") as f:
        f.write(source)
    cmd = [_cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented kernel:\n{proc.stderr}")
    return lib


def measure(lib, pb: int, batch: int = 128) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(pb)
    X = torch.randn((batch, 8192, pb), generator=gen, device="cuda")
    A = X.mT @ X + 100.0 * torch.eye(pb, device="cuda")
    out = torch.empty_like(A)
    prof = torch.zeros(MAX_STAMPS + 1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.chol_inv_panel_launch(A.data_ptr(), out.data_ptr(), batch, pb, stream,
                                       prof.data_ptr())
        if rc != 0:
            raise RuntimeError(f"instrumented launch failed: cudaError {rc}")

    for _ in range(100):
        launch()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        launch()
    stop.record()
    stop.synchronize()
    stamps = prof.cpu().tolist()
    n = int(stamps[MAX_STAMPS])
    if not 2 <= n <= MAX_STAMPS:
        raise RuntimeError(f"{n} stamps: the instrumented kernel did not run to its end")
    return {"pb": pb, "batch": batch, "ms": start.elapsed_time(stop) / 200,
            "cycles": stamps[n - 1] - stamps[0],
            "intervals": [stamps[i + 1] - stamps[i] for i in range(n - 1)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pb", type=int, nargs="+", default=[188, 187, 64])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("panel_cycles: needs a CUDA device")
    lib = ctypes.CDLL(build())
    lib.chol_inv_panel_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p] * 2)
    lib.chol_inv_panel_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    for pb in args.pb:
        print(json.dumps(measure(lib, pb)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
