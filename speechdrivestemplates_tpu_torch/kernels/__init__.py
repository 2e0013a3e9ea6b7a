"""Build, bind and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for Hopper (``nvcc -gencode arch=compute_90a,code=sm_90a``) into
``build/lib<name>.so`` at the repository root and loaded with ``ctypes``;
pointers and the CUDA stream go over as ``c_void_p``. A library is rebuilt
when its source is newer. ``build_all()`` compiles every source at once, one
``nvcc`` process each.

``LAUNCHES`` counts, per kernel, the calls in which its wrapper launched it
(the wrappers in ``ops/`` add one right where they launch, nowhere else).
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# name -> {C function: argtypes}; every function returns cudaError_t as int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "mel": {"sdt_mel_forward": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "stem": {"sdt_stem_forward": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _F, _P]},
}

LAUNCHES: collections.Counter = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use and need the CUDA toolkit")
    return path


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"lib{name}.so"
    src = CSRC / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build_all(names=None) -> dict:
    """Compile the named (default: all) kernels that are missing or stale, all
    ``nvcc`` processes started together. Returns ``{name: seconds}`` for the
    ones built."""
    names = list(names or SIGNATURES)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, t0 = {}, time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    took, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (rc {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, BUILD_DIR / f"lib{n}.so")
        took[n] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
