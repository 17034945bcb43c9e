"""Build and load the port's hand-written CUDA sources (``csrc/*.cu``).

Each source is compiled on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface under ``_build/`` (git-ignored), one library per source,
named by a hash of its content, and loaded with ``ctypes``.  Nothing here runs
at import: the CPU tests import every module, and there is no ``nvcc`` there.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

_libs: dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
_ptxas_logs: dict[str, str] = {}  # source -> what ptxas -v said at its last build


def sources() -> list[str]:
    """Every CUDA source of the port, by file name (``chol_inv_panel.cu``, ...)."""
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the "
                       "kernels in csrc/")


def build(source: str, force: bool = False, verbose: bool = False) -> str:
    """Compile ``csrc/<source>`` into ``BUILD_DIR`` (once per source content).

    Returns the path of the shared library.  The file name carries a hash of
    the source, so an edited source is rebuilt and never confused with an
    older library; the library is written to a temporary name and renamed
    into place, so a concurrent build never sees a partial file.  ``force``
    rebuilds even when the library exists; ``verbose`` prints what
    ``ptxas -v`` reports (registers, shared memory, spills).
    """
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.isfile(lib_path) and not force:
        return lib_path
    nvcc = _nvcc()
    proc = compile_library(
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                     "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, src],
        lib_path, f"nvcc on {source}")
    _ptxas_logs[source] = proc.stderr
    if verbose:
        print(f"{source}:\n{proc.stderr}", flush=True)
    return lib_path


def compile_library(command, lib_path: str, what: str) -> subprocess.CompletedProcess:
    """Run ``command(out)``, a compiler call that writes a shared library to
    ``out``, on a temporary name in ``BUILD_DIR`` and rename the result to
    ``lib_path``, so a concurrent build never loads a partial file.  A failed
    call raises with the compiler's output; returns the finished process."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc


def _demangle(names: list[str]) -> list[str]:
    tool = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    if not names or not os.path.isfile(tool):
        return names
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                          check=False)
    out = proc.stdout.splitlines()
    return out if proc.returncode == 0 and len(out) == len(names) else names


def ptxas_report() -> list[dict]:
    """Per kernel built in this process: registers, spill bytes and static
    shared memory, as ``ptxas -v`` reported them (dynamic shared memory is
    set at launch and not listed)."""
    rows = []
    for source, log in sorted(_ptxas_logs.items()):
        for chunk in re.split(r"Compiling entry function '", log)[1:]:
            used = re.search(r"Used (\d+) registers", chunk)
            smem = re.search(r"(\d+) bytes smem", chunk)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            rows.append({
                "source": source, "kernel": chunk.split("'", 1)[0],
                "registers": int(used.group(1)) if used else None,
                "spill_store_bytes": int(spills.group(1)) if spills else None,
                "spill_load_bytes": int(spills.group(2)) if spills else None,
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
            })
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def build_all(force: bool = False, verbose: bool = False) -> dict[str, str]:
    """Build every source at once, one ``nvcc`` each, all started together."""
    srcs = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(srcs))) as pool:
        paths = pool.map(lambda s: build(s, force=force, verbose=verbose), srcs)
        return dict(zip(srcs, paths))


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built at first use.

    ``signatures`` maps each C entry point to its ``argtypes``; every entry
    point returns an ``int`` (a ``cudaError_t``).
    """
    with _libs_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
    return lib
