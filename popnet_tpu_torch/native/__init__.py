"""The native host assembler: greedy person assembly in C++, bound with
ctypes (`csrc/assembler.cpp`, built with the host C++ compiler at first
use by `ops._build.host_library`).

`assemble_batch_native` is the default assembly of the Open-Pose+
evaluation's host route (`cli/evaluate.py run_openpose_eval`,
`use_native=True`), as the JAX package's `popnet_tpu/native` is of its
`evaluate`. It differs from the NumPy assembler (`decode/assemble.py`) in
one way: a frame keeps at most `max_people` people, the first that pass
the part and score filters. There is no fallback: where no host C++
compiler builds the library, the call raises, naming the compiler.
"""

from __future__ import annotations

import ctypes

import numpy as np

from popnet_tpu_torch.ops._build import host_library

_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    lib = host_library("assembler")
    if not getattr(lib, "_typed", False):
        lib.popnet_assemble_batch.restype = ctypes.c_int
        lib.popnet_assemble_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _I32, _F32, _U8, _F32, _U8, ctypes.c_float, ctypes.c_int, _F32, _I32]
        lib._typed = True
    return lib


def assemble_batch_native(peaks, peak_valid, scores, ok, limbs, max_people: int = 16,
                          min_parts: int = 3, min_score: float = 0.2):
    """peaks (B, K, M, 3) float32, peak_valid (B, K, M), scores (B, L, M, M)
    float32, ok (B, L, M, M), limbs (L, 2) -> (joints (B, max_people, K, 3)
    float32, counts (B,) int32). A row's joints are (x, y, conf), with (-1,
    -1, 0) where the person has no such joint; rows past a frame's count
    are zero."""
    lib = _lib()
    peaks = np.ascontiguousarray(peaks, dtype=np.float32)
    valid = np.ascontiguousarray(peak_valid, dtype=np.uint8)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    ok = np.ascontiguousarray(ok, dtype=np.uint8)
    limbs = np.ascontiguousarray(np.asarray(limbs), dtype=np.int32)
    B, K, M, _ = peaks.shape
    L = scores.shape[1]
    joints = np.zeros((B, max_people, K, 3), np.float32)
    counts = np.zeros((B,), np.int32)
    lib.popnet_assemble_batch(
        B, K, L, M, max_people, limbs.ctypes.data_as(_I32), peaks.ctypes.data_as(_F32),
        valid.ctypes.data_as(_U8), scores.ctypes.data_as(_F32), ok.ctypes.data_as(_U8),
        ctypes.c_float(min_score), int(min_parts), joints.ctypes.data_as(_F32),
        counts.ctypes.data_as(_I32))
    return joints, counts


def human_lists(joints, counts, num_joints: int) -> list:
    """(joints, counts) of `assemble_batch_native` -> per frame (humans,
    visibility, conf), the human-list contract of `decode.assemble`: a
    missing joint is [-1, -1] with visibility 0 (the JAX package's
    `run_openpose_eval`)."""
    out = []
    for b in range(joints.shape[0]):
        hs, vs, cs = [], [], []
        for p in range(int(counts[b])):
            row = joints[b, p]
            hs.append([[float(row[k, 0]), float(row[k, 1])] if row[k, 0] >= 0 else [-1, -1]
                       for k in range(num_joints)])
            vs.append([int(row[k, 0] >= 0) for k in range(num_joints)])
            cs.append([float(row[k, 2]) for k in range(num_joints)])
        out.append((hs, vs, cs))
    return out
