"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain `extern "C"` interface and compiles on
its own into `build/popnet_tpu_torch/lib<name>-<hash>.so` under the
checkout (git-ignored); the hash of the source and of the shared headers
(`csrc/*.cuh`) names the library, so an edited source never loads a stale
build. Sources build at first use, never at import. `build_all` starts one
nvcc per source at once and returns ptxas's register and shared-memory
report for each. A source's `stamps` build (-DPOPNET_STAGE_CLOCKS) records
per-block stage clocks (csrc/common.cuh); only measurements load it.

The host sources (`HOST_SOURCES`, `csrc/<name>.cpp`: the JPEG reader and
writer, the uint8 image transforms and the line and circle rasterizer) build the same way with the host C++ compiler
(`c++`, the one nvcc also drives), not nvcc, so they build wherever the
package runs, the CPU too (`host_library`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "popnet_tpu_torch"
SOURCES = ("find_peaks", "paf_score", "readout", "assemble", "peak_mask")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCES = ("jpeg_decode", "jpeg_encode", "image_u8", "draw_u8")
# no contraction into fused multiply-adds but where the source writes std::fma
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-ffp-contract=off")

_loaded: dict[tuple, ctypes.CDLL] = {}
_host_lock = threading.Lock()     # one build of a host source a process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str, stamps: bool = False) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}{'-stamps' if stamps else ''}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES, stamps=()) -> dict[str, str]:
    """Compile every source not yet built, all nvcc processes at once:
    `names` as they run, `stamps` with stage clocks.

    Returns {name (or name-stamps): ptxas report} for the builds made by
    this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, stamped in [(n, False) for n in names] + [(n, True) for n in stamps]:
            out = _target(name, stamped)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            flags = (*NVCC_FLAGS, "-DPOPNET_STAGE_CLOCKS") if stamped else NVCC_FLAGS
            cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            key = f"{name}-stamps" if stamped else name
            procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            os.replace(tmp, out)
            reports[name] = log
        return reports
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def library(name: str, stamps: bool = False) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (its stage-clock build with
    `stamps`), built on first use."""
    key = (name, stamps)
    lib = _loaded.get(key)
    if lib is None:
        build_all(() if stamps else (name,), (name,) if stamps else ())
        lib = ctypes.CDLL(str(_target(name, stamps)))
        _loaded[key] = lib
    return lib


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no host C++ compiler (c++ or g++, or $CXX): the port's JPEG reader and "
                       "writer, uint8 image transforms and rasterizer (csrc/*.cpp) build with "
                       "it at first use")


def _host_target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of the host source `csrc/<name>.cpp`, built with
    the host C++ compiler on first use (`CXX_FLAGS`); raises naming what is
    missing when no compiler is found."""
    key = (name, "host")
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _host_lock:
        if key in _loaded:
            return _loaded[key]
        out = _host_target(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"the host C++ compiler failed on {name}.cpp:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = _loaded[key] = ctypes.CDLL(str(out))
    return lib
