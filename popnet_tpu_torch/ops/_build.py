"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain `extern "C"` interface and compiles on
its own into `build/popnet_tpu_torch/lib<name>-<hash>.so` under the
checkout (git-ignored); the hash of the source names the library, so an
edited source never loads a stale build. Sources build at first use, never
at import. `build_all` starts one nvcc per source at once and returns
ptxas's register and shared-memory report for each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "popnet_tpu_torch"
SOURCES = ("find_peaks", "paf_score", "readout", "assemble", "peak_mask")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not yet built, all nvcc processes at once.

    Returns {name: ptxas report} for the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
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


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
