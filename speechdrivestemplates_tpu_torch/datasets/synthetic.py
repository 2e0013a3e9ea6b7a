"""A synthetic speaker directory in the reference layout: one npz per clip
(``pose`` (T, 3, 137), ``audio``, ``imgs``) and ``processed_137.csv``, so the
train path runs end to end without downloads. For one seed it writes the same
arrays and csv as the JAX package's ``datasets/synthetic.py``.
"""

from __future__ import annotations

import csv
import os

import numpy as np

CSV_COLUMNS = ("dataset", "pose_fn", "speaker", "start", "end", "interval",
               "video_fn", "audio_fn")


def make_synthetic_speaker(root_dir: str, speaker: str = "oliver",
                           num_train: int = 12, num_dev: int = 4,
                           num_frames: int = 64, audio_length: int = 68267,
                           seed: int = 0, offset_scale: float = 1.0) -> str:
    """Create ``root_dir/<speaker>/`` with clips and csv; returns the speaker dir.

    Poses are a torso swaying around the canvas centre plus per-clip keypoint
    offsets (scaled by ``offset_scale``) and noise, scores in (0.5, 1); audio
    is a sine sweep."""
    rng = np.random.RandomState(seed)
    speaker_dir = os.path.join(root_dir, speaker)
    os.makedirs(speaker_dir, exist_ok=True)

    rows = []
    for i in range(num_train + num_dev):
        t = np.arange(num_frames)[:, None]
        base_x = 640 + 40 * np.sin(2 * np.pi * t / 32 + rng.rand() * 6)
        base_y = 360 + 20 * np.cos(2 * np.pi * t / 24 + rng.rand() * 6)
        kx = (rng.rand(1, 137) * 300 - 150) * offset_scale
        ky = (rng.rand(1, 137) * 300 - 150) * offset_scale
        x = base_x + kx + rng.randn(num_frames, 137) * 2
        y = base_y + ky + rng.randn(num_frames, 137) * 2
        score = 0.5 + 0.5 * rng.rand(num_frames, 137)
        pose = np.stack([x, y, score], axis=1).astype(np.float32)  # (T, 3, 137)

        n = np.arange(audio_length)
        f0 = 80 + 400 * rng.rand()
        audio = (0.1 * np.sin(2 * np.pi * f0 * n / 16000 * (1 + n / audio_length))
                 ).astype(np.float32)

        fn = f"clip_{i:04d}.npz"
        np.savez(os.path.join(speaker_dir, fn), pose=pose, audio=audio,
                 imgs=np.array([], dtype=np.bytes_))
        rows.append({"dataset": "train" if i < num_train else "dev", "pose_fn": fn,
                     "speaker": speaker, "start": 0, "end": num_frames,
                     "interval": f"i{i}", "video_fn": "synthetic.mp4",
                     "audio_fn": "synthetic.wav"})

    with open(os.path.join(speaker_dir, "processed_137.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_COLUMNS, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return speaker_dir

