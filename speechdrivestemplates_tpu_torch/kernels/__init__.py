"""Build, bind and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for Hopper (``nvcc -gencode arch=compute_90a,code=sm_90a``) into
``build/lib<name>.so`` at the repository root and loaded with ``ctypes``;
pointers and the CUDA stream go over as ``c_void_p``. A library is rebuilt
when its source is newer. ``build_all()`` compiles every source at once, one
``nvcc`` process each.

Importing this package registers the kernels as ``torch.library`` custom
ops, ``torch.ops.sdt.{mel, conv1_in, stem, shift_taps, bn_act, in_act,
in_act_stats, ln_gelu}`` (``kernels/ops.py``); the ``ctypes`` calls live in those ops'
CUDA implementations alone. The wrappers in ``ops/`` check their inputs and call
the ops, and an exported serving graph (``utils/export.py``) calls them too,
so a process that loads one imports this package first.

``LAUNCHES`` counts, per kernel, the calls in which an op's implementation
launched it (one right where it launches, nowhere else; a fake call, as
``torch.export`` makes, counts nothing). A launch made while a stream
captures a CUDA graph is recorded, not run: the graph runner
(``pipelines/graphed.py``) adds those to ``CAPTURED``, and each replay adds
the graph's captured launches to ``REPLAYED``. ``executions()`` counts the
kernels that ran: ``LAUNCHES - CAPTURED + REPLAYED``. ``LAYOUTS`` counts the
same launches of a kernel that reads more than one layout by the layout it
was handed, ``LAYOUTS["bn_act", "channels_last"]`` and so on. ``ATTENTION``
counts the attention calls the host ran (eager, or once at a graph's capture)
by SDPA backend: ``"flash"``, ``"cudnn"`` (a biased attention on the card,
``speech_encoder.BIASED_BACKEND``) or ``"math"`` (``models/speech_encoder.py``).

The kernels are forward-only, as the JAX package's Pallas kernels are: they
write through raw pointers, and the ops have no autograd formula. Each
wrapper calls ``refuse_grad`` first, so a gradient is never dropped silently.
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
    "mel": {"sdt_mel_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "conv1": {"sdt_conv1_in_forward": [_P, _P, _P, _I, _P, _I, _I, _F, _P]},
    "stem": {"sdt_stem_forward": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _F, _P]},
    "shift_probe": {"sdt_shift_taps_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "bn_act": {"sdt_bn_act_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]},
    "in_act": {"sdt_in_act_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]},
    "ln_gelu": {"sdt_ln_gelu_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P]},
}

# what the wrappers in ops/ take: CUDA tensors, and meta tensors, whose shapes
# the ops' fakes give (a trace of the card's route on a machine without one)
DEVICE_TYPES = ("cuda", "meta")

LAUNCHES: collections.Counter = collections.Counter()
CAPTURED: collections.Counter = collections.Counter()
REPLAYED: collections.Counter = collections.Counter()
LAYOUTS: collections.Counter = collections.Counter()
ATTENTION: collections.Counter = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for c in (LAUNCHES, CAPTURED, REPLAYED, LAYOUTS, ATTENTION):
        c.clear()


def executions() -> collections.Counter:
    """Per kernel, the launches that ran: eager launches plus replayed ones."""
    out = collections.Counter(LAUNCHES)
    out.subtract(CAPTURED)
    out.update(REPLAYED)
    return +out


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


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would record through a forward-only kernel: grad
    mode is on and one of ``tensors`` requires grad."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward and its output would carry no gradient: call "
            "it under torch.no_grad() or torch.inference_mode(), or train through "
            "the plain version (a model in train() mode takes it)")


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


from . import ops  # noqa: E402,F401  (registers torch.ops.sdt.*)
