"""Audio length bookkeeping (the reference's ``audio_processing.py``) and the
wav reader of the demo and the serving command line.

``load_wav`` is the JAX package's (``utils/audio.py``), the reference's
librosa load without librosa: a ``.wav`` is read by ``scipy.io.wavfile``
(PCM of 8, 16 or 32 bits, or float), averaged to mono and resampled to the
target rate by ``scipy.signal.resample_poly``; any other container is decoded
by the ``ffmpeg`` binary, and raises where there is none.
"""

from __future__ import annotations

import shutil
import subprocess

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


def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """Mono float32 samples of an audio file at ``target_sr``."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    if not path.lower().endswith(".wav"):
        return _load_via_ffmpeg(path, target_sr)
    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # (samples, channels)
        data = data.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return np.ascontiguousarray(data, dtype=np.float32)


def _load_via_ffmpeg(path: str, target_sr: int) -> np.ndarray:
    """Any container ffmpeg decodes, as mono float32 PCM at ``target_sr``."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"non-wav audio ({path}) needs the ffmpeg binary, which is not "
                           "on PATH; convert it to a .wav first")
    out = subprocess.run([ffmpeg, "-i", path, "-f", "f32le", "-ac", "1", "-ar",
                          str(target_sr), "pipe:1"], check=True, capture_output=True)
    return np.frombuffer(out.stdout, dtype=np.float32).copy()
