"""Build a source of csrc/ into a shared library with a plain C interface,
for loading with ctypes.

`build_library(source)` compiles a CUDA source with nvcc for sm_90a;
`build_host_library(source)` compiles a host C++ source with g++. Both
write into `build/` at the repository root, named by a hash of the source,
the compiler and its flags (an edit rebuilds), unless that library is there
already. `KernelLibrary` is the one loader of the kernel modules: a source
and its functions' ctypes signatures, built at first use and loaded once.
A compiler runs only at a library's first use (nvcc only on the machine
with the card); importing this module runs nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(source: str, compiler: str, flags: List[str]) -> Tuple[str, str]:
    with open(source, "rb") as f:
        key = f.read() + " ".join([os.path.basename(compiler), *flags]).encode()
    digest = hashlib.sha1(key).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, source], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on {source}:\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, log


def build_library(source: str) -> Tuple[str, str]:
    """Compile the CUDA `source` (a path) into build/lib<stem>_<hash>.so
    unless it is there already. Returns the library's path and the
    compiler's report (registers, spills; empty when nothing was compiled)."""
    return _build(source, _nvcc(), NVCC_FLAGS)


def build_host_library(source: str) -> Tuple[str, str]:
    """Compile the host C++ `source` with g++ (-O2 -shared -fPIC) into
    build/lib<stem>_<hash>.so unless it is there already. Returns the
    library's path and the compiler's output."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source} cannot be built")
    return _build(source, gxx, GXX_FLAGS)


class KernelLibrary:
    """A csrc/ source with a plain C interface, compiled by `compile`
    (`build_library` or `build_host_library`) at first use and loaded once
    with ctypes, each function of `signatures` (name -> (argtypes,
    restype)) bound to its types. `build_log` keeps the compiler's report
    (registers, spills) of the last build that compiled, through later
    builds that found the library already built."""

    def __init__(self, source: str, signatures: Dict[str, Tuple[Sequence, object]],
                 compile: Callable[[str], Tuple[str, str]] = build_library):
        self.source, self.signatures, self.compile = source, signatures, compile
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile the source into build/ unless its library is there
        already; returns the library's path."""
        path, log = self.compile(self.source)
        self.build_log = log or self.build_log
        return path

    def load(self) -> ctypes.CDLL:
        """The loaded library, built and bound at the first call."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(self.build())
                    for name, (argtypes, restype) in self.signatures.items():
                        fn = getattr(lib, name)
                        fn.argtypes, fn.restype = list(argtypes), restype
                    self._lib = lib
        return self._lib

    def module_attr(self, name: str):
        """A kernel module's `__getattr__`: its `build_log` is this one's."""
        if name == "build_log":
            return self.build_log
        raise AttributeError(f"no attribute {name!r}")
