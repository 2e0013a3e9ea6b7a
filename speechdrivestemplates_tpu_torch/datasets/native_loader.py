"""The native item loader: a C++ core that reads a train or val item.

Counterpart of the JAX package's ``datasets/native_loader.py``.
``load_clip_native`` runs a 121-keypoint item's whole pipeline in
``csrc/sdt_dataio.cpp``: the npz read, the keypoint selection, root-centering,
the hierarchical re-rooting, the z-score, and the audio crop or pad. Its items
equal the numpy route's (``gesture_dataset.load_clip_numpy``) bit for bit. ctypes
releases the GIL for the call, so threads load items at once.

The library is built at first use with the host's C++ compiler (``c++``, zlib)
into ``build/libsdt_dataio.so`` at the repository root, and rebuilt when the
source is newer. An ``fcntl`` lock serializes builds across processes, and a
build is compiled under a temporary name and moved into place, so concurrent
processes never race or load a half-written file. A failed build raises with the
compiler's output, and so does a library of another ABI version. (JAX's returns
None then, silently; its build script also compiles with ``-march=native``, which
this build does not.)

``SDT_DISABLE_NATIVE`` (any non-empty value; read at each call, as JAX reads it)
turns the core off: items then take the numpy route. A clip the core rejects
(``sdt_load_clip`` returns a code below 0, named in ``REASONS``) takes the numpy
route too; ``REJECTED`` counts the rejections of this process by code, and the
first is logged.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sdt_dataio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARY = "libsdt_dataio.so"
ABI_VERSION = 1
# -ffp-contract=off: each float operation as written, no fused multiply-add, so
# the core rounds as numpy does on every host
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
REASONS = {-1: "the file does not read", -2: "no pose.npy", -3: "no audio.npy",
           -4: "the pose is not (T, 3, 137)", -5: "fewer than NUM_FRAMES frames",
           -6: "a payload not float32 / float64 in C order, or cut short"}

REJECTED: collections.Counter = collections.Counter()
_log = logging.getLogger(__name__)
_libs: dict = {}
_lock = threading.Lock()
_said_disabled = False


def _disabled() -> bool:
    """True when ``SDT_DISABLE_NATIVE`` turns the core off (logged once)."""
    global _said_disabled
    if not os.environ.get("SDT_DISABLE_NATIVE"):
        return False
    if not _said_disabled:
        _said_disabled = True
        _log.info("SDT_DISABLE_NATIVE is set: 121-keypoint items take the numpy route")
    return True


def _library_path(build_dir=None) -> Path:
    return Path(build_dir or BUILD_DIR) / LIBRARY


def _stale(so: Path) -> bool:
    return not so.exists() or so.stat().st_mtime < SOURCE.stat().st_mtime


def _compile_command(out) -> list:
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++) on PATH: the native item loader is built "
                           "at first use; set SDT_DISABLE_NATIVE=1 to read items with numpy")
    return [cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE), "-lz"]


def ensure_built(build_dir=None) -> Optional[float]:
    """Build the library into ``build_dir`` (default: ``build/``) where it is
    missing or older than its source. Returns the compile's seconds where this
    call compiled, else None. Raises RuntimeError with the compiler's output
    where the build fails."""
    so = _library_path(build_dir)
    if not _stale(so):
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / f"{LIBRARY}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not _stale(so):  # another process built it while this one waited
            return None
        tmp = so.parent / f"{LIBRARY}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        r = subprocess.run(_compile_command(tmp), capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the native item loader failed (rc {r.returncode}): "
                               f"{' '.join(r.args)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
        return time.perf_counter() - t0


def library(build_dir=None) -> ctypes.CDLL:
    """The loaded core, built first where needed; raises where it cannot be
    built or is not ABI version 1."""
    so = _library_path(build_dir)
    lib = _libs.get(so)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(so)
        if lib is None:
            ensure_built(build_dir)
            lib = ctypes.CDLL(str(so))
            lib.sdt_dataio_abi_version.argtypes = []
            lib.sdt_dataio_abi_version.restype = ctypes.c_int
            version = lib.sdt_dataio_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{so}: ABI version {version}, expected {ABI_VERSION}; "
                                   f"delete it to rebuild from {SOURCE}")
            fp = ctypes.POINTER(ctypes.c_float)
            lib.sdt_load_clip.restype = ctypes.c_int
            lib.sdt_load_clip.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                          fp, fp, fp, fp, fp, ctypes.c_long]
            _libs[so] = lib
    return lib


def native_available() -> bool:
    """True when 121-keypoint items take the core: ``SDT_DISABLE_NATIVE`` is
    unset, and the library is built and loaded (raising where it cannot be)."""
    if _disabled():
        return False
    library()
    return True


def load_clip_native(path: str, num_frames: int, hierarchical: bool, mean: np.ndarray,
                     std: np.ndarray, audio_len: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``(poses (T, 2, 121), scores (T, 2, 121), audio (audio_len,))``, float32,
    of the clip npz at ``path``, T = ``num_frames``; None where
    ``SDT_DISABLE_NATIVE`` is set or the core rejects the clip (counted in
    ``REJECTED``)."""
    if _disabled():
        return None
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.size != 242 or std.size != 242 or num_frames < 1 or audio_len < 0:
        raise ValueError(f"load_clip_native: mean and std of 242 values, num_frames >= 1, "
                         f"audio_len >= 0 (got {mean.size}, {std.size}, {num_frames}, "
                         f"{audio_len})")
    lib = library()
    poses = np.empty((num_frames, 2, 121), np.float32)
    scores = np.empty((num_frames, 2, 121), np.float32)
    audio = np.empty((audio_len,), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.sdt_load_clip(os.fsencode(path), num_frames, int(hierarchical),
                           mean.ctypes.data_as(fp), std.ctypes.data_as(fp),
                           poses.ctypes.data_as(fp), scores.ctypes.data_as(fp),
                           audio.ctypes.data_as(fp), audio_len)
    if rc != 0:
        with _lock:
            REJECTED[rc] += 1
            first = sum(REJECTED.values()) == 1
        if first:
            _log.warning("native item loader: %s rejected (%d: %s); it and any later "
                         "rejected clip take the numpy route (REJECTED counts them)",
                         path, rc, REASONS.get(rc, "unknown"))
        return None
    return poses, scores, audio
