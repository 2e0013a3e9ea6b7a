"""Audio length bookkeeping (the reference's ``audio_processing.py``)."""

from __future__ import annotations

import numpy as np


def parse_audio_length(audio_length: int, sr: int, fps: int) -> tuple[int, int]:
    """Snap an audio length to a whole number of video frames:
    ``(int(num_frames * sr / fps), num_frames)`` with
    ``num_frames = int(audio_length / (sr / fps))``."""
    bit_per_frames = sr / fps
    num_frames = int(audio_length / bit_per_frames)
    return int(num_frames * bit_per_frames), num_frames


def crop_pad_audio(wav: np.ndarray, audio_length: int) -> np.ndarray:
    """Crop or zero-pad a 1-D waveform to exactly ``audio_length`` samples."""
    if len(wav) > audio_length:
        return wav[:audio_length]
    if len(wav) < audio_length:
        return np.pad(wav, [0, audio_length - len(wav)], mode="constant")
    return wav
