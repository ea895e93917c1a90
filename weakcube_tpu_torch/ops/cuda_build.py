"""Build a CUDA source of csrc/ into a shared library with a plain C
interface, for loading with ctypes.

`build_library(source)` compiles with nvcc for sm_90a into `build/` at the
repository root, named by a hash of the source and the flags (an edit
rebuilds), unless that library is there already. The compiler runs only on
the machine with the card, at a kernel's first use; importing this module
runs nothing.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(source: str) -> Tuple[str, str]:
    """Compile `source` (a path) into build/lib<stem>_<hash>.so unless it is
    there already. Returns the library's path and the compiler's report
    (registers, spills; empty when nothing was compiled)."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log
