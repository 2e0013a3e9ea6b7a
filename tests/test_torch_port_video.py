"""The port's ``VideoWriter`` (``utils/video.py``) against the JAX package's:
each sink writes JAX's file names, the tensorboard sink JAX's GIF payload byte
for byte, the cv2 mp4 decodes to its T frames; the async queue is drained
when the writer closes and when a run ends; a writer that does not open is
an error in the log. A CPU demo and a CPU test run with TEST.SAVE_VIDEO hand
the writer the frames of JAX's ``generate_video`` / ``generate_video_pair``
for the same poses; K steps a dispatch with TRAIN.SAVE_VIDEO fall back to one
step a dispatch and save the videos, as JAX does. Canvas (180, 320), <= 8
frames, as the JAX package's own video tests."""

import glob
import logging
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu.config import get_cfg_defaults
from speechdrivestemplates_tpu.utils import tb_native as jax_tb
from speechdrivestemplates_tpu.utils import viz as jax_viz
from speechdrivestemplates_tpu.utils.video import VideoWriter as JaxVideoWriter
from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, sdt_bp
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.utils import tb_native, video

SMALL = ["SYS.CANVAS_SIZE", "(180, 320)"]


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("video") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=3, seed=7)
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(*opts):
    jcfg = get_cfg_defaults()
    jcfg.merge_from_list(list(opts))
    return apply_overrides(pose2pose(), list(opts)), jcfg


def _clip(seed, t=6):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (t, 90, 160, 3)).astype(np.uint8)
    return frames, (rng.randn(16000) * 0.1).astype(np.float32)


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "*", "*")))


def _read_mp4(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            return np.stack(frames) if frames else np.zeros((0,))
        frames.append(f)


@pytest.mark.parametrize("tag, extra_id", [("TRAIN", None), ("VAL", None), ("TEST", None),
                                           ("DEMO", None), ("DEMO", 2)])
def test_sinks_write_the_jax_names_and_payloads(tmp_path, tag, extra_id):
    opts = ["SYS.VIDEO_FORMAT", "['tensorboard', 'mp4', 'img']"]
    cfg, jcfg = _cfgs(*opts)
    frames, audio = _clip(1)
    long_img = np.full((720, 900, 3), 255, np.uint8)
    runs = {}
    for name, writer_cls, tb in (("jax", JaxVideoWriter, jax_tb), ("port", video.VideoWriter,
                                                                  tb_native)):
        base = str(tmp_path / name)
        tbw = tb.NativeTBWriter(base)
        vw = writer_cls(jcfg if name == "jax" else cfg)
        vw.save_video(jcfg if name == "jax" else cfg, tag, frames, 3, 2, global_step=7,
                      long_img=long_img, audio=audio, writer=tbw, base_path=base,
                      extra_id=extra_id)
        tbw.close()
        events = glob.glob(os.path.join(base, "events.*"))
        runs[name] = (base, _files(base), jax_tb.read_events(events[0]))
    (_, jfiles, jev), (pbase, pfiles, pev) = runs["jax"], runs["port"]
    assert pfiles == jfiles
    suffix = "" if extra_id is None else f"-{extra_id}"
    stem = f"epoch2-{tag}-step3{suffix}"
    assert f"videos/{stem}.mp4" in pfiles and f"videos/{stem}.wav" in pfiles
    assert (f"imgs/{stem}.jpg" in pfiles) == (tag == "DEMO")
    assert [(e["step"], e["tag"], e["png"]) for e in pev] == \
        [(e["step"], e["tag"], e["png"]) for e in jev]
    if tag != "DEMO":
        assert [(e["tag"], e["step"]) for e in pev] == [
            ("train/video", 7) if tag == "TRAIN" else (f"{tag.lower()}/video/3", 2)]
        gif = tb_native.gif_decode(pev[0]["png"])
        assert gif.shape == (6, 36, 64, 3)  # 0.4x
    else:
        assert pev == []
    decoded = _read_mp4(os.path.join(pbase, "videos", f"{stem}.mp4"))
    assert decoded.shape == (6, 90, 160, 3)
    from scipy.io import wavfile

    sr, wav = wavfile.read(os.path.join(pbase, "videos", f"{stem}.wav"))
    assert sr == 16000 and np.array_equal(wav, audio)


def test_async_queue_is_drained_on_close(tmp_path, monkeypatch):
    cfg, _ = _cfgs("SYS.VIDEO_FORMAT", "['mp4']", "SYS.ASYNC_VIDEO_SAVING", "True")
    gate = threading.Event()
    real = video._write_with_cv2

    def slow(*args):
        gate.wait(10)
        return real(*args)

    monkeypatch.setattr(video, "_write_with_cv2", slow)
    vw = video.VideoWriter(cfg)
    frames, audio = _clip(2)
    for step in (1, 2, 3):
        vw.save_video(cfg, "TRAIN", frames, step, 1, step, audio=audio, base_path=str(tmp_path))
    assert not glob.glob(str(tmp_path / "videos" / "*.mp4"))  # queued behind the gate
    threading.Timer(0.2, gate.set).start()
    vw.close()
    assert sorted(os.listdir(tmp_path / "videos")) == sorted(
        f"epoch1-TRAIN-step{s}.{e}" for s in (1, 2, 3) for e in ("mp4", "wav"))
    assert vw.thread is None


def test_async_failure_and_unopened_writer_are_logged(tmp_path, caplog):
    cfg, _ = _cfgs("SYS.VIDEO_FORMAT", "['mp4']", "SYS.ASYNC_VIDEO_SAVING", "True")
    frames, _ = _clip(3)
    with caplog.at_level(logging.INFO):
        bad = str(tmp_path / "nowhere" / "x.mp4")
        assert video._write_with_cv2(frames, bad, 15) is False
        vw = video.VideoWriter(cfg)
        vw.save_video(cfg, "TRAIN", frames, 1, 1, 1, base_path=None)  # os.path.join(None)
        vw.close()
    errors = [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert any(bad in r.getMessage() and "could not open" in r.getMessage() for r in errors)
    assert any("async video save failed" in r.getMessage() for r in errors)


def _recorder(monkeypatch):
    calls = []
    real = video.VideoWriter.save_video

    def save_video(self, cfg, tag, frames, step, epoch, global_step=None, long_img=None,
                   audio=None, writer=None, base_path=None, extra_id=None):
        calls.append(SimpleNamespace(tag=tag, frames=frames, step=step, epoch=epoch,
                                     global_step=global_step, long_img=long_img, audio=audio,
                                     extra_id=extra_id))
        return real(self, cfg, tag, frames, step, epoch, global_step, long_img, audio, writer,
                    base_path, extra_id)

    monkeypatch.setattr(video.VideoWriter, "save_video", save_video)
    return calls


def test_test_and_demo_hand_the_writer_the_jax_frames(speaker_root, tmp_path, monkeypatch):
    """SDT-BP at full width, fp32: a test run's pair videos and a demo's
    prediction video and filmstrip are JAX's ``generate_video_pair`` /
    ``generate_video`` / ``draw_pose_frames_in_long_img`` of the poses the
    run archived; the demo writes JAX's mp4, wav and jpg names."""
    from scipy.io import wavfile

    from speechdrivestemplates_tpu.pipelines.voice2pose import Voice2Pose
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState

    opts = ["DATASET.ROOT_DIR", speaker_root, "SYS.OUTPUT_DIR", str(tmp_path / "runs"),
            "TEST.BATCH_SIZE", "2", "SYS.NUM_WORKERS", "0", "TEST.SAVE_VIDEO", "True",
            "SYS.VIDEO_FORMAT", "['mp4', 'img']", *SMALL]
    cfg = apply_overrides(sdt_bp(precision="fp32"), list(opts))
    jcfg = get_cfg_defaults()
    jcfg.merge_from_list(["SYS.CANVAS_SIZE", "(180, 320)"])
    jself = SimpleNamespace(cfg=jcfg)
    ckpt = str(tmp_path / "bp.pth")
    Voice2PoseTrainState(cfg, 4, "cpu").save_checkpoint(ckpt, 1, 2)
    calls = _recorder(monkeypatch)

    tested = trainer.test(cfg, ckpt, "t", "cpu")
    assert [(c.tag, c.step, c.epoch) for c in calls] == [("TEST", 1, 0), ("TEST", 2, 0)]
    for c in calls:
        with np.load(os.path.join(tested["output_dir"], "results",
                                  f"epoch0-TEST-step{c.step}.npz")) as z:
            pred, gt = z["poses_pred_batch"][0], z["poses_gt_batch"][0]
        np.testing.assert_array_equal(c.frames,
                                      Voice2Pose.generate_video_pair(jself, pred, gt))
        assert c.frames.shape == (64, 180, 320, 3) and c.audio.shape == (68266,)

    calls.clear()
    wav = str(tmp_path / "talk.wav")
    wavfile.write(wav, 16000, (np.random.RandomState(5).randn(16000) * 3000).astype(np.int16))
    out = trainer.demo(cfg, ckpt, wav, "d", "cpu")
    assert [(c.tag, c.step, c.epoch, c.extra_id) for c in calls] == [("DEMO", 1, 0, None)]
    with np.load(out["npz"][0]) as z:
        pred = z["poses_pred_batch"][0]
    np.testing.assert_array_equal(calls[0].frames, Voice2Pose.generate_video(jself, pred))
    np.testing.assert_array_equal(calls[0].long_img,
                                  jax_viz.draw_pose_frames_in_long_img(pred.transpose(0, 2, 1)))
    assert _files(out["output_dir"]) == ["imgs/epoch0-DEMO-step1.jpg",
                                         "results/epoch0-DEMO-step1.npz",
                                         "videos/epoch0-DEMO-step1.mp4",
                                         "videos/epoch0-DEMO-step1.wav"]
    assert _read_mp4(os.path.join(out["output_dir"], "videos",
                                  "epoch0-DEMO-step1.mp4")).shape[0] == out["num_frames"][0]


def test_k_steps_with_videos_fall_back_and_save_them(speaker_root, tmp_path, monkeypatch, caplog):
    """TRAIN.STEPS_PER_DISPATCH 2 with DATASET.CACHING and TRAIN.SAVE_VIDEO:
    the device cache declines (JAX's reason), training runs one step a
    dispatch and saves each result step's pair video, asynchronously here,
    all written when the run returns; the epoch figure is in the event file."""
    cfg = apply_overrides(pose2pose(), [
        "DATASET.ROOT_DIR", speaker_root, "SYS.OUTPUT_DIR", str(tmp_path), "TRAIN.BATCH_SIZE",
        "2", "TRAIN.NUM_EPOCHS", "1", "TRAIN.VALIDATE", "False", "SYS.NUM_WORKERS", "0",
        "DATASET.CACHING", "True", "TRAIN.STEPS_PER_DISPATCH", "2", "TRAIN.SAVE_VIDEO", "True",
        "SYS.VIDEO_FORMAT", "['mp4', 'tensorboard']", "SYS.ASYNC_VIDEO_SAVING", "True", *SMALL])
    calls = _recorder(monkeypatch)
    with caplog.at_level(logging.INFO):
        out = trainer.train(cfg, "k2", "cpu")
    text = caplog.text
    assert "device cache disabled: per-step artifact saving needs host batches" in text
    assert "falling back to one dispatch per step" in text
    assert [(c.tag, c.step, c.global_step) for c in calls] == [("TRAIN", 1, 1), ("TRAIN", 2, 2)]
    assert sorted(os.listdir(os.path.join(out["output_dir"], "videos"))) == [
        f"epoch1-TRAIN-step{s}.{e}" for s in (1, 2) for e in ("mp4", "wav")]
    events = jax_tb.read_events(glob.glob(os.path.join(out["output_dir"], "events.*"))[0])
    images = [(e["tag"], e["step"]) for e in events if "png" in e]
    assert sorted(images) == [("train/clip_code", 1), ("train/video", 1), ("train/video", 2)]
