"""Streaming wav -> poses: feed audio chunks, receive finished pose frames
(the JAX package's ``utils/streaming.py``).

A session cuts the stream into the windows of the windowed demo
(``ops/longform.py``) as their audio arrives, runs each through
``forward_fn`` and blends them with the same ramp, so a stream fed whole
returns the windowed demo's poses bit for bit, given the same forward. The
latency is one window (64 frames, about 4.3 s) at most; a window's forward
finishes one stride (32 frames) of output.

``forward_fn`` maps (1, window_samples) float32 audio to (1, window_frames,
2, K) poses; with the port, ``serving.build_serving_fn`` at the window's shape
(64 frames, 68,266 samples), its code bound (on the card every window has one
signature, so from the second window on a call replays one CUDA graph)::

    fn, _ = build_serving_fn(cfg, state_dict)
    sess = StreamingPoseSession(lambda a: fn(a, code).float().cpu().numpy())
    for chunk in chunks:
        frames = sess.feed(chunk)
    frames = sess.flush()

or, without the model code, an artifact exported at B = 1 and the window's
length (``utils.export.export_serving_fn(..., audio_length=68266)``), which
takes the same arguments: ``fn = load_serving_fn(path)``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..ops.longform import AUDIO_SR, SAMPLES_PER_FRAME, VIDEO_FPS, crossfade_ramp
from .audio import parse_audio_length


class StreamingPoseSession:
    """Incremental windowed wav -> poses with the offline crossfade."""

    def __init__(self, forward_fn: Callable, window_frames: int = 64,
                 halo_frames: int = 16, num_keypoints: int = 121):
        assert window_frames > 2 * halo_frames, "window must exceed its halos"
        self.forward_fn = forward_fn
        self.window_frames = window_frames
        self.halo_frames = halo_frames
        self.stride = window_frames - 2 * halo_frames
        self.window_samples = int(window_frames * SAMPLES_PER_FRAME)
        self._num_kp = num_keypoints  # until the first forward gives K
        self._ramp = crossfade_ramp(window_frames, halo_frames)[:, None, None]
        self._audio = np.zeros((0,), np.float32)  # the stream's unconsumed tail
        self._consumed = 0  # samples dropped off the left
        self._next_window = 0  # next regular window's index
        self._acc: Optional[np.ndarray] = None  # ramp-weighted pose sums
        self._wgt: Optional[np.ndarray] = None  # their weights
        self._acc_start = 0  # frame of _acc[0]
        self._emitted = 0  # frames returned so far
        self._finished = False

    def _window_bounds(self, start_frame: int):
        a0 = int(start_frame * SAMPLES_PER_FRAME)
        return a0, a0 + self.window_samples

    def _frames_received(self) -> int:
        """Frames of the audio received so far, by ``parse_audio_length`` as
        the demo dataset counts them, so that the windows run are those of
        ``plan_windows`` for this much audio."""
        return parse_audio_length(self._consumed + len(self._audio), AUDIO_SR, VIDEO_FPS)[1]

    def _run_window(self, start_frame: int, audio_win: np.ndarray) -> None:
        poses = np.asarray(self.forward_fn(audio_win[None]))[0]
        assert poses.shape[0] == self.window_frames, poses.shape
        self._num_kp = poses.shape[-1]
        if self._acc is None:
            self._acc = np.zeros((0, 2, poses.shape[-1]), np.float64)
            self._wgt = np.zeros((0, 1, 1), np.float64)
            self._acc_start = start_frame
        end = start_frame + self.window_frames
        have = self._acc_start + self._acc.shape[0]
        if end > have:
            grow = end - have
            self._acc = np.concatenate([self._acc, np.zeros((grow,) + self._acc.shape[1:])])
            self._wgt = np.concatenate([self._wgt, np.zeros((grow, 1, 1))])
        lo = start_frame - self._acc_start
        self._acc[lo: lo + self.window_frames] += poses * self._ramp
        self._wgt[lo: lo + self.window_frames] += self._ramp

    def _empty(self) -> np.ndarray:
        return np.zeros((0, 2, self._num_kp), np.float32)

    def _emit_through(self, frame_end: int) -> np.ndarray:
        """Frames [emitted, frame_end), finished; dropped from the buffers."""
        if self._acc is None or frame_end <= self._emitted:
            return self._empty()
        lo = self._emitted - self._acc_start
        hi = frame_end - self._acc_start
        out = (self._acc[lo:hi] / self._wgt[lo:hi]).astype(np.float32)
        self._acc = self._acc[hi:]
        self._wgt = self._wgt[hi:]
        self._acc_start = frame_end
        self._emitted = frame_end
        return out

    @property
    def frames_emitted(self) -> int:
        return self._emitted

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Append samples; returns the frames finished by them (maybe none):
        those no later window can reach."""
        assert not self._finished, "session already flushed"
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self._audio = np.concatenate([self._audio, chunk])
        emitted: List[np.ndarray] = []
        while True:
            start = self._next_window * self.stride
            # a regular window exists once start + window <= frames received
            if start + self.window_frames > self._frames_received():
                break
            a0, a1 = self._window_bounds(start)
            self._run_window(start, self._audio[a0 - self._consumed: a1 - self._consumed])
            self._next_window += 1
            # flush() may end the stream at once with a window ending at the
            # last frame, which starts after this one: frames <= start are final
            emitted.append(self._emit_through(start + 1))
            keep_from, _ = self._window_bounds(start + 1)
            drop = keep_from - self._consumed
            if drop > 0:
                self._audio = self._audio[drop:]
                self._consumed = keep_from
        if not emitted:
            return self._empty()
        return np.concatenate(emitted)

    def flush(self) -> np.ndarray:
        """End of stream: the last window (ending at the last frame, or
        zero-padded for a stream shorter than one window, as ``plan_windows``
        places it) and every frame left."""
        assert not self._finished, "session already flushed"
        self._finished = True
        num_frames = self._frames_received()
        if num_frames <= 0:
            return self._empty()
        covered = ((self._next_window - 1) * self.stride + self.window_frames
                   if self._next_window > 0 else 0)
        if covered < num_frames:
            start = max(num_frames - self.window_frames, 0)
            a0, _ = self._window_bounds(start)
            win = np.zeros((self.window_samples,), np.float32)
            seg = self._audio[max(a0 - self._consumed, 0):][: self.window_samples]
            win[: len(seg)] = seg
            self._run_window(start, win)
        return self._emit_through(num_frames)
