"""Long-form (windowed) inference: audio of any length through the generator
at one fixed window shape (the JAX package's ``ops/longform.py``).

The waveform is cut into windows of ``window_frames`` frames that overlap by
two halos; the windows run as one batch; the per-window poses are blended
back into one sequence with a linear crossfade over each halo. The generator
is convolutional with a bounded receptive field but normalizes each window
over its own frames, so the result approximates one dense forward. The
streaming session (``utils/streaming.py``) uses the same plan and the same
ramp, and so returns the same poses bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

AUDIO_SR = 16000
VIDEO_FPS = 15
SAMPLES_PER_FRAME = AUDIO_SR / VIDEO_FPS


def plan_windows(num_frames: int, window_frames: int = 64,
                 halo_frames: int = 16) -> list:
    """``[(start, window_frames), ...]``: window starts (in frames) one stride
    (window - 2 halo) apart from 0, and a last window ending at
    ``num_frames`` where the stride grid does not reach it."""
    assert window_frames > 2 * halo_frames, "window must exceed its two halos"
    stride = window_frames - 2 * halo_frames
    starts = list(range(0, max(num_frames - window_frames, 0) + 1, stride))
    if not starts:
        starts = [0]
    if starts[-1] + window_frames < num_frames:
        starts.append(num_frames - window_frames)
    return [(s, window_frames) for s in starts]


def window_audio(audio: np.ndarray, num_frames: int, window_frames: int = 64,
                 halo_frames: int = 16) -> Tuple[np.ndarray, list]:
    """``(windows, plan)``: (N, int(window_frames * 16000 / 15)) float32
    windows of ``audio`` (L,), each zero-padded where the audio ends."""
    plan = plan_windows(num_frames, window_frames, halo_frames)
    l_w = int(window_frames * SAMPLES_PER_FRAME)
    out = np.zeros((len(plan), l_w), dtype=np.float32)
    for i, (start, _) in enumerate(plan):
        a0 = int(start * SAMPLES_PER_FRAME)
        seg = audio[a0: a0 + l_w]
        out[i, : len(seg)] = seg
    return out, plan


def crossfade_ramp(window_frames: int, halo_frames: int) -> np.ndarray:
    """A window's blend weights: linear fades over each halo, floored at 1e-3
    so that no weight vanishes."""
    ramp = np.ones(window_frames)
    if halo_frames > 0:
        fade_in = np.linspace(0.0, 1.0, halo_frames, endpoint=False)
        ramp[:halo_frames] = fade_in
        ramp[-halo_frames:] = fade_in[::-1]
    return np.maximum(ramp, 1e-3)


def stitch_windows(poses: np.ndarray, plan: list, num_frames: int,
                   halo_frames: int = 16) -> np.ndarray:
    """(N, window_frames, 2, K) window poses -> (num_frames, 2, K) float32,
    the ramp-weighted mean of the windows over each frame (in float64). The
    ramp applies with one window too, where the weights cancel, as the
    streaming session cannot know the number of windows ahead."""
    w = poses.shape[1]
    out = np.zeros((num_frames,) + poses.shape[2:], dtype=np.float64)
    weight = np.zeros((num_frames, 1, 1), dtype=np.float64)
    ramp = crossfade_ramp(w, halo_frames)
    for i, (start, size) in enumerate(plan):
        stop = min(start + size, num_frames)
        k = stop - start
        out[start:stop] += poses[i, :k] * ramp[:k, None, None]
        weight[start:stop] += ramp[:k, None, None]
    return (out / weight).astype(np.float32)
