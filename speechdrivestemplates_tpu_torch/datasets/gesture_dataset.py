"""The train, val and demo splits, and the train schedule.

Counterpart of the JAX package's ``datasets/gesture_dataset.py``. A speaker
directory holds one npz per clip and ``processed_137.csv``, whose ``dataset``
column marks the train rows (``'train'``) and the val rows (``'dev'``). An
item is the clip's audio cropped or zero-padded to whole video frames, its first
NUM_FRAMES poses taken to 121 keypoints, re-rooted per part and z-scored with
the speaker's parted statistics, its row index in the split (``clip_index``,
for the train split the row of the clip-code bank) and those statistics.
With DATASET.HIERARCHICAL_POSE False (s2g) the poses stay global, are
z-scored with the speaker's global statistics, which ``speaker_stat`` then
holds, and the item carries them again as ``speaker_stat_global`` (the FGD
encoder's re-normalization reads that key, as in JAX).

The demo split (``demo_input``: a wav path, a space-separated list of paths,
or a directory, whose sorted listing is shuffled by
``numpy.random.default_rng(SYS.SEED)`` and cut to DEMO.NUM_SAMPLES wavs) has
no poses: an item is the wav at 16 kHz (``utils.audio.load_wav``), cropped to
DATASET.MAX_DEMO_LENGTH seconds at a start drawn from
``default_rng(SYS.SEED + index)``, snapped to whole frames, or zero-padded to
NUM_FRAMES frames where it is shorter (the UNet's downsampling needs one
window); its frame count ``num_frames``, its index and the speaker's
statistics.

``EpochBatches`` is the JAX loader's train schedule, a ``RandomState(seed +
epoch)`` shuffle of the row indices in full batches only, so a port run and a
JAX run see the same batches; with ranks, each takes its shard of them as the
JAX loader's ``num_shards``/``shard_index`` do (``shard_indices``) (``pipelines.trainer.train_loader`` feeds it to
``torch.utils.data.DataLoader``, or, with DATASET.CACHING, to ``CachedLoader``).

With DATASET.CACHING (the JAX ``GestureDataset``'s option of that name) an
item is read once and kept; ``materialize()`` stacks the whole split once into
structure-of-arrays numpy arrays (``speaker_stat`` nested), and
``gather(indices)`` makes a batch of one fancy-indexed slice per key. These
arrays are what the trainer stages on the card (DATASET.DEVICE_CACHE).

A 121-keypoint item (DATASET.NUM_LANDMARKS 121, as in JAX) is read by the
native C++ core (``native_loader.load_clip_native``), else, or where
``SDT_DISABLE_NATIVE`` is set or the core rejects the clip, by numpy
(``load_clip_numpy``); the two give the same item bit for bit. A train or val
dataset builds and loads the core when it is made, so the loader's worker
processes, forked later, inherit it built.

    python -m speechdrivestemplates_tpu_torch.datasets.gesture_dataset [root] [speaker]

prints the configuration and the train split's size, and writes item 0's
first 8 frames, drawn, under a new temporary directory (JAX's smoke run).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import pose as pose_ops
from ..utils.audio import crop_pad_audio, load_wav, parse_audio_length
from . import native_loader
from .speakers_stat import get_speaker_stat


SPLIT_ROWS = {"train": "train", "val": "dev"}


def demo_clips(demo_input: str, seed: int, num_samples: int) -> List[str]:
    """The wav paths of ``--demo_input``, as the JAX demo split lists them."""
    if len(demo_input.split()) == 1 and os.path.isdir(demo_input):
        files = sorted(os.listdir(demo_input))
        np.random.default_rng(seed).shuffle(files)
        files = [f for f in files[:1000] if f.split(".")[-1] == "wav"][:num_samples]
        return [os.path.join(demo_input, f) for f in files]
    return demo_input.split()


class GestureDataset:
    """The ``split`` ('train', 'val' or 'demo') clips: of ``root_dir/<speaker>``
    (``'a+b'`` joins speakers), or of ``demo_input`` for the demo."""

    def __init__(self, root_dir: str, speaker: str, cfg, split: str = "train",
                 demo_input: Optional[str] = None):
        if speaker is None:
            raise ValueError("DATASET.SPEAKER is not set")
        if split not in (*SPLIT_ROWS, "demo"):
            raise ValueError(f"unknown split {split!r}: 'train', 'val' or 'demo'")
        self.cfg = cfg.DATASET
        self.seed = cfg.SYS.SEED
        self.split = split
        self.speaker = speaker.replace("+", " ").split()[0]
        self._cache: Dict[int, Dict[str, object]] = {}
        self._soa: Optional[Dict[str, object]] = None
        self.clips: List = []
        if split == "demo":
            if demo_input is None:
                raise ValueError("the demo split needs demo_input")
            self.clips = demo_clips(demo_input, cfg.SYS.SEED, cfg.DEMO.NUM_SAMPLES)
        else:
            for sp in speaker.replace("+", " ").split():
                sp_dir = os.path.join(root_dir, sp)
                path = os.path.join(sp_dir, "processed_137.csv")
                if not os.path.exists(path):
                    raise FileNotFoundError(f"No csv file: {path}")
                with open(path, newline="") as f:
                    self.clips += [dict(row, _dir=sp_dir) for row in csv.DictReader(f)
                                   if row["dataset"] == SPLIT_ROWS[split]]
        if self.cfg.SUBSET is not None:
            self.clips = self.clips[: self.cfg.SUBSET]
        self.audio_length, self.num_frames = parse_audio_length(
            self.cfg.AUDIO_LENGTH, self.cfg.AUDIO_SR, self.cfg.FPS)
        if split != "demo" and self.cfg.NUM_LANDMARKS == 121:
            native_loader.native_available()  # built here, before any worker forks

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        if self.split == "demo":
            return self._demo_item(idx)
        if not self.cfg.CACHING:
            return self._load_item(idx)
        if self._soa is not None:
            return _take(self._soa, idx)
        if idx not in self._cache:
            self._cache[idx] = self._load_item(idx)
        return self._cache[idx]

    def materialize(self) -> Optional[Dict[str, object]]:
        """The split as SoA arrays, (N, ...) per key, built once (DATASET.CACHING
        only; None without it)."""
        if not self.cfg.CACHING or self.split == "demo":
            return None
        if self._soa is None:
            self._soa = stack([self[i] for i in range(len(self))])
            self._cache.clear()  # the item cache is redundant now
        return self._soa

    def gather(self, indices) -> Dict[str, object]:
        """A batch of numpy arrays: one fancy-indexed slice of the SoA arrays
        per key."""
        return _take(self.materialize(), np.asarray(indices, dtype=np.int64))

    def _load_item(self, idx: int) -> Dict[str, object]:
        clip = self.clips[idx]
        parted = self.cfg.HIERARCHICAL_POSE
        stat = get_speaker_stat(clip["speaker"], 121, parted=parted)
        path = os.path.join(clip["_dir"], clip["pose_fn"])
        got = None
        if self.cfg.NUM_LANDMARKS == 121:
            got = native_loader.load_clip_native(path, self.cfg.NUM_FRAMES, parted,
                                                 stat["mean"], stat["std"], self.audio_length)
        if got is None:
            poses, audio = load_clip_numpy(path, self.cfg.NUM_FRAMES, parted, stat["mean"],
                                           stat["std"], self.audio_length,
                                           self.cfg.NUM_LANDMARKS)
        else:
            poses, _, audio = got
        item = {"audio": audio, "poses": poses, "clip_index": np.int64(idx),
                "speaker_stat": stat}
        if not parted:
            item["speaker_stat_global"] = get_speaker_stat(clip["speaker"], 121, parted=False)
        return item

    def _demo_item(self, idx: int) -> Dict[str, object]:
        path, c = self.clips[idx], self.cfg
        if path.split(".")[-1] not in ("wav", "m4a"):
            raise ValueError(f"demo input {path!r}: a .wav (or, with ffmpeg, .m4a) file")
        audio = load_wav(path, c.AUDIO_SR)
        if c.MAX_DEMO_LENGTH is not None:
            max_length = c.MAX_DEMO_LENGTH * c.AUDIO_SR
            if len(audio) > max_length:
                start = int(np.random.default_rng(self.seed + idx).integers(
                    0, len(audio) - max_length))
                audio = audio[start: start + max_length]
        audio_length, num_frames = parse_audio_length(len(audio), c.AUDIO_SR, c.FPS)
        if num_frames < c.NUM_FRAMES:
            num_frames = c.NUM_FRAMES
            audio_length = int(num_frames * c.AUDIO_SR / c.FPS)
        return {"audio": crop_pad_audio(audio, audio_length).astype(np.float32),
                "clip_index": np.int32(idx),
                "speaker_stat": get_speaker_stat(self.speaker, 121,
                                                 parted=c.HIERARCHICAL_POSE),
                "num_frames": np.int32(num_frames)}


def load_clip_numpy(path: str, num_frames: int, hierarchical: bool, mean: np.ndarray,
                    std: np.ndarray, audio_len: int, num_landmarks: int = 121):
    """``(poses (T, 2, K), audio (audio_len,))``, float32, of the clip npz at
    ``path`` by numpy: its first ``num_frames`` poses taken to 121 keypoints,
    root-centred, re-rooted per part where ``hierarchical``, z-scored with
    ``mean`` / ``std`` (2K,); its audio cropped or zero-padded. The native
    core's plain version, and the route of other layouts."""
    with np.load(path) as arr:
        audio = crop_pad_audio(np.asarray(arr["audio"], np.float32), audio_len)
        pose = np.asarray(arr["pose"][:num_frames], np.float32)
    rel = pose_ops.absolute_to_relative(pose_ops.remove_unused_kp(pose))
    if hierarchical:
        rel = pose_ops.global_to_parted(rel)
    poses = pose_ops.normalize_poses(rel[:, :2, :], mean, std, num_landmarks)
    return poses.astype(np.float32), audio.astype(np.float32)


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree[idx]


def stack(samples: List[Dict[str, object]]) -> Dict[str, object]:
    """Stack items into numpy arrays (``speaker_stat`` nested once)."""
    out: Dict[str, object] = {}
    for key, v0 in samples[0].items():
        if isinstance(v0, dict):
            out[key] = {k: np.stack([np.asarray(s[key][k]) for s in samples]) for k in v0}
        else:
            out[key] = np.stack([np.asarray(s[key]) for s in samples])
    return out


def to_torch(batch, pin: bool = False):
    """Numpy arrays -> CPU tensors, in page-locked memory with ``pin``."""
    if isinstance(batch, dict):
        return {k: to_torch(v, pin) for k, v in batch.items()}
    t = torch.from_numpy(np.ascontiguousarray(batch))
    return t.pin_memory() if pin else t


def collate(samples: List[Dict[str, object]]) -> Dict[str, object]:
    """Stack items into a batch of CPU tensors (``speaker_stat`` nested once)."""
    return to_torch(stack(samples))


def shard_indices(num_items: int, num_shards: int = 1, shard_index: int = 0,
                  seed: Optional[int] = None) -> np.ndarray:
    """One rank's row indices, as the JAX ``DataLoader._indices`` makes them:
    ``arange(num_items)``, shuffled by ``RandomState(seed)`` unless ``seed``
    is None, padded by repeating its head up to a multiple of ``num_shards``
    (every shard then holds as many rows, and so as many batches), then every
    ``num_shards``-th row from ``shard_index``."""
    idx = np.arange(num_items)
    if seed is not None:
        np.random.RandomState(seed).shuffle(idx)
    if num_shards > 1:
        pad = -(-num_items // num_shards) * num_shards - num_items
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        idx = idx[shard_index::num_shards]
    return idx


class EpochBatches:
    """The JAX loader's train schedule, as a ``batch_sampler``: the row indices
    shuffled by ``RandomState(seed + epoch)``, full batches only; with
    ``num_shards`` > 1, shard ``shard_index``'s rows of them
    (``shard_indices``), ``batch_size`` being the per-shard batch."""

    def __init__(self, num_items: int, batch_size: int, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0):
        self.num_items = num_items
        self.batch_size = batch_size
        self.seed = seed
        self.num_shards, self.shard_index = num_shards, shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def index_batches(self) -> List[np.ndarray]:
        idx = shard_indices(self.num_items, self.num_shards, self.shard_index,
                            self.seed + self.epoch)
        return [idx[i: i + self.batch_size]
                for i in range(0, len(idx) - self.batch_size + 1, self.batch_size)]

    def __len__(self) -> int:
        return -(-self.num_items // self.num_shards) // self.batch_size

    def __iter__(self):
        return (b.tolist() for b in self.index_batches())


class CachedLoader:
    """The train loader with DATASET.CACHING: the batches of ``EpochBatches``
    gathered from the dataset's SoA arrays in this process (no worker
    processes: the arrays live here), as CPU tensors, page-locked with
    ``pin``. The same interface as the ``DataLoader`` it replaces:
    ``dataset``, ``batch_sampler`` (``set_epoch``), ``len`` and iteration."""

    def __init__(self, dataset: GestureDataset, batch_sampler: EpochBatches, pin: bool = False):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.pin = pin

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self):
        for idx in self.batch_sampler.index_batches():
            yield to_torch(self.dataset.gather(idx), self.pin)


if __name__ == "__main__":
    import sys
    import tempfile

    import cv2

    from ..config import load_config
    from ..utils.viz import vis_relative_pose_clip

    opts = ["DATASET.ROOT_DIR", sys.argv[1]] if len(sys.argv) > 1 else []
    opts += ["DATASET.SPEAKER", sys.argv[2]] if len(sys.argv) > 2 else []
    cfg = load_config(None, opts)
    print(cfg)
    ds = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg)
    print(f"{len(ds)} train clips")
    sample, k = ds[0], cfg.DATASET.NUM_LANDMARKS
    stat = sample["speaker_stat"]
    rel = sample["poses"] * stat["std"].reshape(1, 2, k) + stat["mean"].reshape(1, 2, k)
    if cfg.DATASET.HIERARCHICAL_POSE:
        rel = pose_ops.parted_to_global(torch.from_numpy(rel)).numpy()
    frames = vis_relative_pose_clip(rel[:8], (720, 1280))
    out_dir = tempfile.mkdtemp(prefix="sdt_dataset_smoke_")
    for i, frame in enumerate(frames):
        if not cv2.imwrite(f"{out_dir}/frame_{i:03d}.jpg", frame):
            raise OSError(f"cv2 could not write {out_dir}/frame_{i:03d}.jpg")
    print(f"wrote {len(frames)} rendered frames to {out_dir}")
