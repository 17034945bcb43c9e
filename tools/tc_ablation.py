"""What binds the tensor-core streamed count: its time with parts switched off.

Builds variants of ``csrc/streamed_count.cu`` with one part of ``tc_kernel``
switched off and times the count alone (``hopper_metrics._count_tc``) at the
main path's shapes, B = 128 vertices of nv = 1639 rows: streamed_acc_from_factors'
(a bf16 ``Xv_b`` [B, nv, 750] in the engine's padded rows against Z's bf16
planes) and streamed_pairwise_acc's (bf16 preds [B, nv, 1024] against the
unit latents' planes), at default and high.  The counts of a variant with a
part off are meaningless: only its time is read.

    full            the kernel as it is
    no_mma          the wgmmas off: the loads, the pipeline and the epilogue
    no_loads        the TMA loads off (each stage's barrier completes at
                    once): the wgmmas and the epilogue on stale stages
    no_mma_l2       no_mma with every item reading vertex 0's A and Bm, so
                    every load hits L2
    no_mma_b_only   no_mma with Bm's boxes only (32 of a stage's 48 KB)
    no_epilogue     the count skipped: no diagonal, no comparisons (the
                    wgmmas, their drain and the loads stay)
    promotion_128   128-byte L2 promotion in place of 256
    a_evict_last    A's loads with an evict-last L2 policy (A is read again
                    for every column tile of its item)

Each variant runs twice, in turns; one JSON line per (turn, variant,
precision) gives both counts' CUDA-event ms (10 samples after 2 warm-ups),
and streamed_acc_from_factors' with the same ``Xv_b`` in vertex-major rows
([B, nv, K] padded: A's rows 1.5 KB apart instead of the fold slice's
192 KB).
Run from the root of the repo on a machine with a CUDA device and nvcc:

    python3 tools/tc_ablation.py

A one-off measurement, not part of the port: the variants are made by
editing lines of the source's text, so a change to ``tc_kernel`` may need
the patterns below brought up to date (``variants`` names the one it no
longer finds).  The variant libraries go to the port's ``_build/``; nothing
else is changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_decoding_tpu_torch.ops import _cuda_build  # noqa: E402

_WGMMA = "wgmma<W>(acc, smem_desc"
_TX = "mbar_expect_tx(full + stage, kTx);"
_LOAD_A = "tma_load(sa + p * kABytes, &map_a, k0, i0, b, p"
_LOAD_B = "tma_load(sb + p * kBBytes, &map_b, 0, k0, j0 / 64, bb, p"
_PROMOTION = "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"
_TMA5 = "\n// The same for a 5-d tensor map."
_PRODUCER = "if (ptid != 0) return;  // one thread issues the loads"
_HINTED_LOAD = """
// tma_load with an L2 cache policy.
__device__ __forceinline__ void tma_load_hint(uint32_t dst, const CUtensorMap* map, int c0,
                                              int c1, int c2, int c3, uint64_t* bar,
                                              uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
"""
_DIAG = "if (t == 0) {  // the diagonal tile: the thread holding"
_COUNT = "if (j0 + col < g.n) count += acc[i] < (((i >> 1) & 1) ? d1 : d0) ? 1 : 0;"


def _sub(source: str, old: str, new: str, count: int = 1) -> str:
    if source.count(old) != count:
        raise ValueError(f"streamed_count.cu no longer has {old!r} {count} times")
    return source.replace(old, new)


def variants(source: str) -> dict:
    """The ablation's sources, by name, from ``streamed_count.cu``'s text."""
    no_mma = _sub(source, _WGMMA, "if (0) " + _WGMMA)
    return {
        "full": source,
        "no_mma": no_mma,
        "no_loads": _sub(_sub(_sub(source, _TX, "mbar_arrive(full + stage);"),
                              _LOAD_A, "if (0) " + _LOAD_A), _LOAD_B, "if (0) " + _LOAD_B),
        "no_mma_l2": _sub(_sub(no_mma, _LOAD_A, _LOAD_A.replace("i0, b, p", "i0, 0, p")),
                          _LOAD_B, _LOAD_B.replace("bb, p", "0, p")),
        "no_mma_b_only": _sub(_sub(no_mma, _TX, "mbar_expect_tx(full + stage, PB * kBBytes);"),
                              _LOAD_A, "if (0) " + _LOAD_A),
        "no_epilogue": _sub(_sub(source, _DIAG, _DIAG.replace("t == 0", "0")), _COUNT, ""),
        # both tensor maps, A's and Bm's
        "promotion_128": _sub(source, _PROMOTION, _PROMOTION.replace("256B", "128B"), count=2),
        "a_evict_last": _sub(_sub(_sub(source, _TMA5, _HINTED_LOAD + _TMA5), _PRODUCER,
                                  _PRODUCER + "\n    uint64_t policy;\n    asm volatile("
                                  "\"createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\" "
                                  ": \"=l\"(policy));"),
                             _LOAD_A + ", full + stage);",
                             _LOAD_A.replace("tma_load(", "tma_load_hint(")
                             + ", full + stage, policy);"),
    }


def build(name: str, source: str) -> str:
    os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_cuda_build.BUILD_DIR, f"streamed_count_{name}.cu")
    lib = os.path.join(_cuda_build.BUILD_DIR, f"libstreamed_count_{name}.so")
    with open(src, "w") as f:
        f.write(source)
    cmd = [_cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return lib


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    import torch

    from multimodal_decoding_tpu_torch.ops import hopper_metrics as HM

    if not torch.cuda.is_available():
        raise SystemExit("tc_ablation: needs a CUDA device")
    with open(os.path.join(_cuda_build.CSRC_DIR, "streamed_count.cu")) as f:
        sources = variants(f.read())
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: build(*kv), sources.items())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")

    b, nv, k, d = 128, 1639, 750, 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((nv, b, k), generator=gen, device="cuda")
    Xv_b = HM.padded_copy(X, torch.bfloat16).permute(1, 0, 2)
    Xv_rows = HM.padded_copy(X.permute(1, 0, 2), torch.bfloat16)  # rows 1.5 KB apart
    del X
    Z = torch.randn((b, k, nv), generator=gen, device="cuda")
    preds = torch.randn((b, nv, d), generator=gen, device="cuda").to(torch.bfloat16)
    y_unit = HM._unit_rows(torch.randn((nv, d), generator=gen, device="cuda"))

    def ms(fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return sorted(times)[len(times) // 2]

    for turn in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in HM._SIGNATURES.items():
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
            _cuda_build._libs[HM._SOURCE] = lib
            for precision in ("default", "high"):
                planes = HM.PLANES[precision]
                z_p = HM.bf16_planes(Z, planes)
                y_p = HM.bf16_planes(y_unit.mT.unsqueeze(0), planes)
                print(json.dumps({
                    "turn": turn, "variant": name, "precision": precision,
                    "factors_count_ms": ms(lambda: HM._count_tc(
                        "streamed_acc_from_factors", Xv_b, z_p, False, b, nv, k, precision)),
                    "factors_count_vertex_rows_ms": ms(lambda: HM._count_tc(
                        "streamed_acc_from_factors", Xv_rows, z_p, False, b, nv, k,
                        precision)),
                    "pairwise_count_ms": ms(lambda: HM._count_tc(
                        "streamed_pairwise_acc", preds, y_p, True, b, nv, d, precision)),
                }), flush=True)
    _cuda_build._libs.pop(HM._SOURCE, None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
