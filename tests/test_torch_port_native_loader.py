"""The port's native item loader (``datasets/native_loader.py``,
``csrc/sdt_dataio.cpp``) against the JAX package's core and its numpy route,
on the CPU: items bit for bit, parted and global, in the STORED, DEFLATE'd and
float64 + ``imgs`` layouts; the clips the core rejects, which take the numpy
route and are counted; threads; the build at first use (one compile for two
processes, a failed build and another ABI refused); and the port's dataset
and a 2-worker loader epoch with and without ``SDT_DISABLE_NATIVE``. A
4-clip synthetic speaker."""

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from speechdrivestemplates_tpu_torch.config import apply_overrides, s2g, sdt_bp
from speechdrivestemplates_tpu_torch.datasets import native_loader as nl
from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import (GestureDataset,
                                                                       load_clip_numpy)
from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker

pytestmark = pytest.mark.skipif(
    shutil.which("c++") is None,
    reason="no C++ compiler (c++) on PATH: the native item loader is built at first use")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIG_DIR = os.path.join(ROOT, "configs")
T, L = 64, 68266  # NUM_FRAMES, and the audio length snapped to whole frames


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=1, seed=11)
    return root


def _clip(root, i):
    return os.path.join(root, "oliver", f"clip_{i:04d}.npz")


def _stat(parted):
    return get_speaker_stat("oliver", 121, parted)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _jax_numpy_item(root, idx, parted, monkeypatch):
    """The JAX dataset's item through its numpy route, its native core set
    aside as ``tests/test_native_loader.py`` sets it aside."""
    import speechdrivestemplates_tpu.datasets.native_loader as jnl
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JDS

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.DATASET.ROOT_DIR = root
    cfg.DATASET.SPEAKER = "oliver"
    cfg.DATASET.HIERARCHICAL_POSE = parted
    with monkeypatch.context() as m:
        m.setattr(jnl, "load_clip_native", lambda *a, **k: None)
        return JDS(root, "oliver", "train", cfg)[idx]


@pytest.mark.parametrize("parted", [True, False], ids=["parted", "global"])
def test_items_equal_jax_native_and_jax_numpy(speaker_root, parted, monkeypatch):
    from speechdrivestemplates_tpu.datasets.native_loader import load_clip_native as jax_native

    st = _stat(parted)
    for i in range(4):
        got = nl.load_clip_native(_clip(speaker_root, i), T, parted, st["mean"], st["std"], L)
        ref = jax_native(_clip(speaker_root, i), T, parted, st["mean"], st["std"], L)
        for g, r in zip(got, ref):
            _bits_equal(g, r)
        item = _jax_numpy_item(speaker_root, i, parted, monkeypatch)
        np.testing.assert_array_equal(got[0], item["poses"])
        np.testing.assert_array_equal(got[1], item["poses_score"])
        _bits_equal(got[2], item["audio"])
        poses, audio = load_clip_numpy(_clip(speaker_root, i), T, parted, st["mean"],
                                       st["std"], L)
        np.testing.assert_array_equal(got[0], poses)
        _bits_equal(got[2], audio)
    assert not nl.REJECTED


@pytest.mark.parametrize("layout", ["compressed", "float64_imgs"])
def test_other_layouts_equal_the_numpy_route(speaker_root, tmp_path, layout):
    """``np.savez_compressed`` (DEFLATE'd entries) and the layout of
    ``data_preprocess/3_1_generate_clips.py`` (float64 poses and audio, an
    ``imgs`` array of frame paths)."""
    from speechdrivestemplates_tpu.datasets.native_loader import load_clip_native as jax_native

    with np.load(_clip(speaker_root, 2)) as z:
        pose, audio = z["pose"], z["audio"]
    path = str(tmp_path / "clip.npz")
    if layout == "compressed":
        np.savez_compressed(path, pose=pose, audio=audio)
    else:
        imgs = np.array([f"/frames/v_{i:06d}.jpg" for i in range(len(pose))])
        np.savez(path, pose=pose.astype(np.float64) + 1 / 3, imgs=imgs,
                 audio=audio.astype(np.float64) / 3)
    for parted in (True, False):
        st = _stat(parted)
        got = nl.load_clip_native(path, T, parted, st["mean"], st["std"], L)
        poses, ref_audio = load_clip_numpy(path, T, parted, st["mean"], st["std"], L)
        np.testing.assert_array_equal(got[0], poses)
        _bits_equal(got[2], ref_audio)
        for g, r in zip(got, jax_native(path, T, parted, st["mean"], st["std"], L)):
            _bits_equal(g, r)
    assert not nl.REJECTED


def _rewrite(path, code):
    """The clip at ``path`` made one that the core rejects with ``code``."""
    with np.load(path) as z:
        pose, audio = z["pose"], z["audio"]
    if code == -2:
        np.savez(path, audio=audio)
    elif code == -4:  # an extra row: (T, 4, 137), which numpy reads all the same
        np.savez(path, pose=np.concatenate([pose, pose[:, 2:]], axis=1), audio=audio)
    else:
        np.savez(path, pose=pose[: T - 1], audio=audio)


@pytest.mark.parametrize("code", [-2, -4, -5])
def test_a_rejected_clip_takes_the_numpy_route_and_is_counted(speaker_root, tmp_path, code,
                                                              monkeypatch):
    root = str(tmp_path / "speakers")
    shutil.copytree(speaker_root, root)
    _rewrite(_clip(root, 1), code)
    monkeypatch.setattr(nl, "REJECTED", type(nl.REJECTED)())
    ds = GestureDataset(root, "oliver", apply_overrides(sdt_bp(), ["SYS.NUM_WORKERS", "0"]))
    st = _stat(True)
    if code == -2:  # the numpy route finds no pose either
        with pytest.raises(KeyError, match="pose"):
            ds[1]
    else:
        item = ds[1]
        poses, audio = load_clip_numpy(_clip(root, 1), T, True, st["mean"], st["std"], L)
        _bits_equal(item["poses"], poses)
        _bits_equal(item["audio"], audio)
        assert item["poses"].shape == ((T - 1) if code == -5 else T, 2, 121)
    assert dict(nl.REJECTED) == {code: 1}
    ds[0]
    assert dict(nl.REJECTED) == {code: 1}


def test_threads_equal_a_serial_load(speaker_root):
    jobs = [(i % 4, bool(i % 3)) for i in range(16)]

    def load(job):
        i, parted = job
        st = _stat(parted)
        return nl.load_clip_native(_clip(speaker_root, i), T, parted, st["mean"], st["std"], L)

    serial = [load(j) for j in jobs]
    with ThreadPoolExecutor(8) as ex:
        threaded = list(ex.map(load, jobs))
    for s, t in zip(serial, threaded):
        for a, b in zip(s, t):
            _bits_equal(a, b)


_BUILD = """
import sys
from speechdrivestemplates_tpu_torch.datasets import native_loader as nl
took = nl.ensure_built(sys.argv[1])
assert nl.library(sys.argv[1]).sdt_dataio_abi_version() == 1
print("compiled" if took is not None else "fresh")
"""


def test_two_processes_build_once_and_both_load(tmp_path):
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, build], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    assert sorted(o[0].strip() for o in outs) == ["compiled", "fresh"]
    assert sorted(os.listdir(build)) == [nl.LIBRARY, f"{nl.LIBRARY}.lock"]


def test_a_failed_build_and_another_abi_raise(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the native item loader failed"):
        nl.ensure_built(tmp_path / "b1")
    assert not list((tmp_path / "b1").glob("*.tmp"))
    other = tmp_path / "other.cpp"
    other.write_text('extern "C" int sdt_dataio_abi_version() { return 2; }\n')
    monkeypatch.setattr(nl, "SOURCE", other)
    with pytest.raises(RuntimeError, match="ABI version 2, expected 1"):
        nl.library(tmp_path / "b2")


@pytest.mark.parametrize("preset", ["sdt_bp", "s2g"])
def test_dataset_items_equal_with_and_without_the_core(speaker_root, preset, monkeypatch):
    """SDT-BP's parted items and s2g's global ones (``speaker_stat_global``)."""
    cfg = apply_overrides({"sdt_bp": sdt_bp, "s2g": s2g}[preset](),
                          ["DATASET.ROOT_DIR", speaker_root, "SYS.NUM_WORKERS", "0"])
    calls = []
    native = nl.load_clip_native
    monkeypatch.setattr(nl, "load_clip_native", lambda *a: calls.append(a) or native(*a))
    ds = GestureDataset(speaker_root, "oliver", cfg)
    got = [ds[i] for i in range(4)]
    assert len(calls) == 4
    monkeypatch.setenv("SDT_DISABLE_NATIVE", "1")
    ref = [ds[i] for i in range(4)]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        _bits_equal(g["audio"], r["audio"])
        np.testing.assert_array_equal(g["poses"], r["poses"])
        assert g["poses"].dtype == r["poses"].dtype == np.float32
        assert g["clip_index"] == r["clip_index"]
    assert not nl.REJECTED


_EPOCH = """
import hashlib, os, sys
from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.datasets import native_loader as nl
from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

def epoch():
    loader = train_loader(apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", sys.argv[1],
                                                     "TRAIN.BATCH_SIZE", "2",
                                                     "SYS.NUM_WORKERS", "2"]))
    loader.batch_sampler.set_epoch(1)
    out = []
    for b in loader:
        out.append(hashlib.sha256(b"".join(
            t.numpy().tobytes() for t in (b["audio"], b["poses"], b["clip_index"]))).hexdigest())
    return out

native = epoch()
os.environ["SDT_DISABLE_NATIVE"] = "1"
plain = epoch()
assert len(native) == 2 and native == plain, (native, plain)
assert not nl.REJECTED
print("ok")
"""


def test_a_worker_epoch_equals_one_without_the_core(speaker_root):
    """Two worker processes (in a process of its own, which holds no JAX
    threads to fork): one epoch's batches with the core, and with
    ``SDT_DISABLE_NATIVE`` set before the workers fork, equal bit for bit."""
    r = subprocess.run([sys.executable, "-c", _EPOCH, speaker_root],
                       env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
