"""The port's offline keypoint inspectors (``utils/viz.py``: ``vis_train_npz``,
``vis_train_csv_dir``, ``vis_pose_npy`` and the ``npz`` / ``csv`` command
line) against the JAX package's, on the CPU: frames equal as uint8 and the
written files equal byte for byte, at ``max_frames`` 2 (and all 3 frames of
the aligned clip), over a flat canvas and over the video frames a clip names
(two written, one missing); both csv layouts; and the command lines and the
dataset's smoke run in subprocesses."""

import csv
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from speechdrivestemplates_tpu.utils import viz as jax_viz
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.utils import viz

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inspect") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=3, num_dev=1, seed=5)
    return root


@pytest.fixture(scope="module")
def aligned_clip(tmp_path_factory):
    """A clip in ``data_preprocess/3_1_generate_clips.py``'s layout: float64
    (3, 3, 137) pixel-space poses, an ``imgs`` array naming a written frame, a
    missing one and another written one."""
    import cv2

    d = tmp_path_factory.mktemp("aligned")
    rng = np.random.RandomState(2)
    imgs = [str(d / "f0.jpg"), str(d / "missing.jpg"), str(d / "f2.png")]
    for p in (imgs[0], imgs[2]):
        assert cv2.imwrite(p, rng.randint(0, 256, (720, 1280, 3)).astype(np.uint8))
    pose = np.stack([rng.uniform(200, 1000, 137), rng.uniform(100, 600, 137),
                     rng.uniform(0, 1, 137)])[None] + rng.randn(3, 3, 137) * 5
    path = str(d / "clip.npz")
    np.savez(path, pose=pose, imgs=np.array(imgs), audio=rng.randn(16000))
    return path


def _files(d):
    return {os.path.relpath(p, d): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "**", "*.jpg"), recursive=True))}


def _frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("align, max_frames", [(False, 2), (True, 2), (True, None)])
def test_vis_train_npz_equals_jax(aligned_clip, tmp_path, align, max_frames):
    got = viz.vis_train_npz(aligned_clip, str(tmp_path / "port"), max_frames, align)
    os.makedirs(tmp_path / "jax")
    want = jax_viz.vis_train_npz(aligned_clip, str(tmp_path / "jax"), max_frames, align)
    _frames_equal(got, want)
    assert len(got) == (max_frames or 3)
    if align:  # frame 0 over its image, frame 1 (missing) on the flat canvas
        assert (got[0] != 240).mean() > 0.9 and (got[1] == 240).mean() > 0.5
    files = _files(tmp_path / "port")
    assert list(files) == [f"frame_{i:06d}.jpg" for i in range(len(got))]
    assert files == _files(tmp_path / "jax")


@pytest.mark.parametrize("layout", ["processed_137", "reference"])
def test_vis_train_csv_dir_equals_jax(speaker_root, tmp_path, layout):
    """The speaker's ``processed_137.csv`` (``pose_fn`` relative to the
    speaker) and the reference's ``train_<speaker>_137_3.csv`` (absolute)."""
    root = speaker_root
    with open(os.path.join(root, "oliver", "processed_137.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    if layout == "reference":
        root = str(tmp_path / "data")
        shutil.copytree(speaker_root, root)
        with open(os.path.join(root, "train_oliver_137_3.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            for r in rows[::-1]:  # another order than processed_137.csv's
                w.writerow(dict(r, pose_fn=os.path.join(root, "oliver", r["pose_fn"])))
    got = viz.vis_train_csv_dir(root, "oliver", out_dir=str(tmp_path / "port"), max_frames=2,
                                max_clips=2)
    want = jax_viz.vis_train_csv_dir(root, "oliver", out_dir=str(tmp_path / "jax"),
                                     max_frames=2, max_clips=2)
    assert got == want and len(got) == 2
    first = rows[-1 if layout == "reference" else 0]["pose_fn"]
    assert got[0] == os.path.join(root, "oliver", first)
    files = _files(tmp_path / "port")
    assert len(files) == 4 and files == _files(tmp_path / "jax")


@pytest.mark.parametrize("shape", ["3xK", "Kx3"])
def test_vis_pose_npy_equals_jax(tmp_path, shape):
    pose = np.random.RandomState(7).uniform(100, 700, (3, 137)).astype(np.float32)
    path = str(tmp_path / "pose.npy")
    np.save(path, pose if shape == "3xK" else pose.T)
    got = viz.vis_pose_npy(path, str(tmp_path / "port.jpg"))
    want = jax_viz.vis_pose_npy(path, str(tmp_path / "jax.jpg"))
    np.testing.assert_array_equal(got, want)
    assert got.any()
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()


def _run(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-m", *args], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_command_lines(speaker_root, aligned_clip, tmp_path):
    out = _run(tmp_path, "speechdrivestemplates_tpu_torch.utils.viz", "npz", aligned_clip,
               "-o", str(tmp_path / "npz"), "--max-frames", "2", "--align-image")
    assert out.strip() == f"rendered 2 frames to {tmp_path / 'npz'}"
    want = jax_viz.vis_train_npz(aligned_clip, None, 2, True)
    assert list(_files(tmp_path / "npz")) == ["frame_000000.jpg", "frame_000001.jpg"]
    import cv2

    # what was written decodes to what JAX draws, within the JPEG's loss
    back = cv2.imread(str(tmp_path / "npz" / "frame_000001.jpg"))
    assert np.abs(back.astype(int) - want[1]).mean() < 2
    out = _run(tmp_path, "speechdrivestemplates_tpu_torch.utils.viz", "csv", speaker_root,
               "oliver", "--max-clips", "2", "--max-frames", "3")
    assert out.startswith("rendered 2 clips to ")
    d = out.strip().split(" to ", 1)[1]
    assert d.startswith(str(tmp_path))
    assert sorted(_files(d)) == [f"clip_000{c}/frame_00000{i}.jpg" for c in (0, 1)
                                 for i in range(3)]


def test_dataset_smoke_run(speaker_root, tmp_path):
    """``python -m ...datasets.gesture_dataset root speaker``: the
    configuration, the split's size, item 0's first 8 frames drawn."""
    out = _run(tmp_path, "speechdrivestemplates_tpu_torch.datasets.gesture_dataset",
               speaker_root, "oliver")
    assert "3 train clips" in out
    d = out.strip().splitlines()[-1].split(" to ", 1)[1]
    assert d.startswith(str(tmp_path))
    assert sorted(os.listdir(d)) == [f"frame_{i:03d}.jpg" for i in range(8)]
