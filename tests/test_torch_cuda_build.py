"""ops/cuda_build.py::KernelLibrary, the one loader of the kernel modules
(ops/roi_align_cuda.py, flash_attention_cuda.py, nms.py,
batch_norm_cuda.py, bilinear_resize_cuda.py), on tiny host C++ sources built with g++: nvcc and the
card are not needed to check how a library is built, bound and kept."""
import ctypes
import os
import subprocess
import sys
import types

import pytest

from weakcube_tpu_torch.ops import cuda_build, nms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = """#warning "a report to keep"
extern "C" double add3(int a, long long b, double c) { return a + b + c; }
"""
SIGNATURES = {"add3": ([ctypes.c_int, ctypes.c_longlong, ctypes.c_double], ctypes.c_double)}


@pytest.fixture
def source(tmp_path, monkeypatch):
    """A tiny source, built into a build/ of its own; the compiler's runs
    are counted in `source.runs`."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    path = tmp_path / "add3.cpp"
    path.write_text(SOURCE)
    runs, run = [], subprocess.run

    def counted(cmd, *a, **k):
        runs.append(cmd[0])
        return run(cmd, *a, **k)
    monkeypatch.setattr(cuda_build.subprocess, "run", counted)
    return types.SimpleNamespace(path=str(path), runs=runs)


def library(source):
    return cuda_build.KernelLibrary(source.path, SIGNATURES, cuda_build.build_host_library)


def test_signatures_are_bound(source):
    """Each function of the signatures gets its argtypes and restype: a
    64-bit integer and a double pass and return whole (ctypes' default int
    would cut them)."""
    lib = library(source).load()
    assert lib.add3.argtypes == SIGNATURES["add3"][0]
    assert lib.add3.restype is ctypes.c_double
    assert lib.add3(1, 2 ** 40, 0.5) == 1 + 2 ** 40 + 0.5


def test_one_build_is_shared_by_two_loads(source):
    """A library compiles once: the second load returns the loaded library,
    and a second loader of the same source finds the first one's build in
    build/ and binds its own signatures on it."""
    first = library(source)
    assert first.load() is first.load()
    assert len(source.runs) == 1
    second = library(source)
    assert second.load().add3(2, 3, 0.25) == 5.25
    assert len(source.runs) == 1
    assert second.build() == first.build()


def test_build_log_survives_a_cached_build(source):
    """build_log keeps the report of the build that compiled, through later
    builds that found the library built (their own report is empty); a
    kernel module's build_log is its loader's."""
    lib = library(source)
    assert lib.build_log == ""
    lib.build()
    assert "a report to keep" in lib.build_log
    lib.build()
    lib.load()
    assert len(source.runs) == 1 and "a report to keep" in lib.build_log
    assert lib.module_attr("build_log") == lib.build_log


def test_a_kernel_modules_build_log_is_its_loaders(monkeypatch):
    """ops/nms.py's build and build_log are its KernelLibrary's; other
    missing names still raise AttributeError."""
    assert nms.build == nms._library.build
    monkeypatch.setattr(nms._library, "build_log", "ptxas info: 40 registers")
    assert nms.build_log == "ptxas info: 40 registers"
    with pytest.raises(AttributeError):
        nms.no_such_name


def test_importing_the_kernel_modules_runs_no_compiler():
    """Importing the five kernel modules (in a fresh process, with every way
    to start a compiler made to fail) builds and loads nothing."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a[:1]}')\n"
        "subprocess.run = subprocess.Popen = subprocess.check_output = refuse\n"
        "from weakcube_tpu_torch.ops import batch_norm_cuda, bilinear_resize_cuda, "
        "flash_attention_cuda, nms, roi_align_cuda\n"
        "mods = (batch_norm_cuda, bilinear_resize_cuda, flash_attention_cuda, nms, "
        "roi_align_cuda)\n"
        "assert all(m._library._lib is None and m.build_log == '' for m in mods)\n"
        "print('loaded none of', len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "loaded none of 5"
