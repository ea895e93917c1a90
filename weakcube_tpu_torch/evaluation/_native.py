"""ctypes loader of the evaluator's greedy matcher, csrc/eval_match.cpp
(weakcube_tpu/evaluation/_native.py).

The source is built with g++ at first use into `build/` (ops/cuda_build.py::
build_host_library). A build or load failure raises with the compiler's
output: there is no silent fallback to the numpy matcher.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops.cuda_build import CSRC_DIR, build_host_library

SOURCE = os.path.join(CSRC_DIR, "eval_match.cpp")
_lib = None
_lock = threading.Lock()


def get_lib() -> ctypes.CDLL:
    """The matcher's library, built and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build_host_library(SOURCE)
            lib = ctypes.CDLL(path)
            i64, f64, u8 = (ctypes.POINTER(t) for t in
                            (ctypes.c_int64, ctypes.c_double, ctypes.c_uint8))
            lib.greedy_match.argtypes = [i64, ctypes.c_int64, f64, ctypes.c_int64, u8, u8,
                                         f64, ctypes.c_int64, i64, u8]
            lib.greedy_match.restype = None
            _lib = lib
    return _lib


def greedy_match(dt_scores, iou_mat, gt_ignore, iou_thrs, dt_ignore):
    """Greedy matching of one (image, category) at every threshold.
    Returns (dt_matched (T, D) GT index or -1, dt_ig (T, D) bool)."""
    lib = get_lib()
    D, G = iou_mat.shape
    T = len(iou_thrs)
    order = np.argsort(-np.asarray(dt_scores), kind="stable").astype(np.int64)
    iou = np.ascontiguousarray(iou_mat, np.float64)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    di = np.ascontiguousarray(dt_ignore, np.uint8)
    th = np.ascontiguousarray(iou_thrs, np.float64)
    dtm = np.empty((T, D), np.int64)
    dig = np.empty((T, D), np.uint8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.greedy_match(ptr(order, ctypes.c_int64), D, ptr(iou, ctypes.c_double), G,
                     ptr(gi, ctypes.c_uint8), ptr(di, ctypes.c_uint8),
                     ptr(th, ctypes.c_double), T,
                     ptr(dtm, ctypes.c_int64), ptr(dig, ctypes.c_uint8))
    return dtm, dig.astype(bool)
