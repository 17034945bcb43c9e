"""Build the port's host C++ sources (``native/*.cpp``) at first use.

Each source is compiled on its own with the flags of the JAX package's
``native/Makefile`` (``g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared
-lpthread``) into a shared library under ``_build/`` (git-ignored, shared
with ``ops/_cuda_build``).  The library's name carries a hash of the source,
the flags and the host's name, since ``-march=native`` code must not run on
another machine's CPU.  It is written to a temporary name and renamed into
place, so concurrent builds (``pytest -n 6``) never load a partial file.  A
failed build raises with the compiler's output (``_cuda_build.compile_library``).
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil

from multimodal_decoding_tpu_torch.ops._cuda_build import BUILD_DIR, PACKAGE_DIR, compile_library

NATIVE_DIR = os.path.join(PACKAGE_DIR, "native")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found (g++): it is needed to build native/*.cpp")


def build(source: str, force: bool = False) -> str:
    """Compile ``native/<source>`` into ``BUILD_DIR``; returns the library path."""
    src = os.path.join(NATIVE_DIR, source)
    h = hashlib.sha1()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(platform.node().encode())
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")
    if os.path.isfile(lib_path) and not force:
        return lib_path
    cxx = _cxx()
    compile_library(lambda out: [cxx, *CXXFLAGS, "-shared", "-o", out, src, "-lpthread"],
                    lib_path, f"building {source}")
    return lib_path
