"""The train split of a speaker directory, and its batch schedule.

Counterpart of the JAX package's ``datasets/gesture_dataset.py``, train split
only. A speaker directory holds one npz per clip and ``processed_137.csv``,
whose ``dataset`` column marks the train rows (``'train'``). An item is the
clip's audio cropped or zero-padded to whole video frames, its first
NUM_FRAMES poses taken to 121 keypoints, re-rooted per part and z-scored with
the speaker's parted statistics, its row index (``clip_index``, the row of the
clip-code bank) and those statistics.

``EpochBatches`` is the JAX loader's batch schedule, a ``RandomState(seed +
epoch)`` shuffle of the row indices in full batches only, so a port run and a
JAX run see the same batches (``pipelines.trainer.train_loader`` feeds it to
``torch.utils.data.DataLoader``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np
import torch

from ..ops import pose as pose_ops
from ..utils.audio import crop_pad_audio, parse_audio_length
from .speakers_stat import get_speaker_stat


class GestureDataset:
    """The train clips of ``root_dir/<speaker>`` (``'a+b'`` joins speakers)."""

    def __init__(self, root_dir: str, speaker: str, cfg):
        if speaker is None:
            raise ValueError("DATASET.SPEAKER is not set")
        if not cfg.DATASET.HIERARCHICAL_POSE:
            raise NotImplementedError(
                "DATASET.HIERARCHICAL_POSE False (global poses, whose FGD path "
                "re-normalizes parted -> global) is not ported yet: ROADMAP.md "
                "queue A, item 10")
        self.cfg = cfg.DATASET
        self.clips: List[Dict[str, str]] = []
        for sp in speaker.replace("+", " ").split():
            sp_dir = os.path.join(root_dir, sp)
            path = os.path.join(sp_dir, "processed_137.csv")
            if not os.path.exists(path):
                raise FileNotFoundError(f"No csv file: {path}")
            with open(path, newline="") as f:
                self.clips += [dict(row, _dir=sp_dir) for row in csv.DictReader(f)
                               if row["dataset"] == "train"]
        if self.cfg.SUBSET is not None:
            self.clips = self.clips[: self.cfg.SUBSET]
        self.audio_length, self.num_frames = parse_audio_length(
            self.cfg.AUDIO_LENGTH, self.cfg.AUDIO_SR, self.cfg.FPS)

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        clip = self.clips[idx]
        stat = get_speaker_stat(clip["speaker"], 121, parted=True)
        with np.load(os.path.join(clip["_dir"], clip["pose_fn"])) as arr:
            audio = crop_pad_audio(np.asarray(arr["audio"], np.float32), self.audio_length)
            pose = np.asarray(arr["pose"][: self.cfg.NUM_FRAMES], np.float32)
        rel = pose_ops.global_to_parted(
            pose_ops.absolute_to_relative(pose_ops.remove_unused_kp(pose)))
        poses = pose_ops.normalize_poses(rel[:, :2, :], stat["mean"], stat["std"],
                                         self.cfg.NUM_LANDMARKS).astype(np.float32)
        return {"audio": audio.astype(np.float32), "poses": poses,
                "clip_index": np.int64(idx), "speaker_stat": stat}


def collate(samples: List[Dict[str, object]]) -> Dict[str, object]:
    """Stack items into a batch of CPU tensors (``speaker_stat`` nested once)."""
    out: Dict[str, object] = {}
    for key, v0 in samples[0].items():
        if isinstance(v0, dict):
            out[key] = {k: torch.from_numpy(np.stack([np.asarray(s[key][k]) for s in samples]))
                        for k in v0}
        else:
            out[key] = torch.from_numpy(np.stack([np.asarray(s[key]) for s in samples]))
    return out


class EpochBatches:
    """The JAX loader's train schedule, as a ``batch_sampler``: the row indices
    shuffled by ``RandomState(seed + epoch)``, full batches only."""

    def __init__(self, num_items: int, batch_size: int, seed: int = 0):
        self.num_items = num_items
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def index_batches(self) -> List[np.ndarray]:
        idx = np.arange(self.num_items)
        np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return [idx[i: i + self.batch_size]
                for i in range(0, len(idx) - self.batch_size + 1, self.batch_size)]

    def __len__(self) -> int:
        return self.num_items // self.batch_size

    def __iter__(self):
        return (b.tolist() for b in self.index_batches())

