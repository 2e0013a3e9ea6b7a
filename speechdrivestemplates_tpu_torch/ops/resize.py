"""Linear / bilinear resize as matmuls with precomputed interpolation matrices.

PyTorch ``F.interpolate(mode='linear'|'bilinear', align_corners=False)``
semantics with NO antialiasing, which is what the reference uses: the audio
encoder squeezes H 5 -> 1 and stretches W 51 -> 64, and the UNet's decoder
upsamples before each additive skip. Each row of the matrix holds at most two
taps, src = clamp((i + 0.5) * in/out - 0.5, 0, in - 1), lerp of floor/ceil.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) torch align_corners=False linear interpolation weights."""
    if in_len == out_len:
        return np.eye(in_len, dtype=np.float32)
    scale = in_len / out_len
    src = (np.arange(out_len, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_len - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_len - 1)
    w1 = (src - i0).astype(np.float64)
    W = np.zeros((out_len, in_len), dtype=np.float64)
    rows = np.arange(out_len)
    np.add.at(W, (rows, i0), 1.0 - w1)
    np.add.at(W, (rows, i1), w1)
    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _resize_tensor(in_len: int, out_len: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    # made outside inference mode: a cached inference tensor (from a serving
    # call) could not be saved for a later train step's backward
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix(in_len, out_len)).to(device, dtype)


# the matrices a CUDA graph has captured: a replay reads them by address,
# so they outlive their eviction from the cache above
_CAPTURED: dict = {}


def _matrix(in_len: int, out_len: int, x: torch.Tensor) -> torch.Tensor:
    W = _resize_tensor(in_len, out_len, x.dtype, x.device)
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        _CAPTURED.setdefault(id(W), W)
    return W


def interpolate_linear_time(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resize the last (time) axis of a (..., T) tensor to ``out_len``."""
    return x @ _matrix(x.shape[-1], out_len, x).T


def interpolate_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize the (H, W) axes of a (..., H, W) tensor — separable, H first."""
    Wh = _matrix(x.shape[-2], out_hw[0], x)
    Ww = _matrix(x.shape[-1], out_hw[1], x)
    return (Wh @ x) @ Ww.T
