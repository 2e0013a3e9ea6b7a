"""The port's TensorBoard writer (``utils/tb_native.py``) against the JAX
package's event reader and CRC, and the tags a training run and a test run
write, at the JAX trainer's steps; the ``SYS.PROFILE`` window's trace. The
image, figure and video (GIF) summaries' payloads equal the JAX writer's
byte for byte (apart from the wall time), the port's reader and GIF decoder
equal JAX's, and a run with videos writes ``train/video``,
``train/clip_code`` and ``test/video/<step>``."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu.utils import tb_native as jax_tb
from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.utils import tb_native


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tb") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=3, seed=5)
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU steps run fastest on one intra-op thread, and the suite runs
    several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(root, out, *opts):
    return apply_overrides(pose2pose(), [
        "DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", out, "TRAIN.BATCH_SIZE", "2",
        "TEST.BATCH_SIZE", "2", "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False",
        "TEST.SAVE_NPZ", "False", "SYS.NUM_WORKERS", "0", *opts])


def _events(run_dir):
    files = glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    return jax_tb.read_events(files[0])


def test_crc32c_known_vectors_and_the_jax_crc():
    # RFC 3720 test vectors for CRC-32C (Castagnoli)
    assert tb_native.crc32c(b"") == 0x00000000
    assert tb_native.crc32c(b"123456789") == 0xE3069283
    assert tb_native.crc32c(bytes(32)) == 0x8A9136AA
    assert tb_native.crc32c(bytes(range(32))) == 0x46DD794E
    rng = np.random.RandomState(0)
    for n in (1, 7, 8, 255, 4096):
        data = rng.bytes(n)
        assert tb_native.crc32c(data) == jax_tb._crc32c(data)
        assert tb_native.masked_crc(data) == jax_tb._masked_crc(data)


def test_scalars_read_back_through_the_jax_reader(tmp_path):
    w = tb_native.NativeTBWriter(str(tmp_path))
    written = [("train/loss", 1.25, 1), ("train/lr_G", 1e-4, 1), ("val/FGD_mu", 22.52, 10),
               ("train/loss", -3.5e-7, 2 ** 40), ("test/L2_dist", 152.197, 0)]
    for tag, value, step in written:
        w.add_scalar(tag, value, step)
    w.close()
    got = jax_tb.read_events(w.path)
    assert [(e["tag"], e["value"], e["step"]) for e in got] == \
        [(t, float(np.float32(v)), s) for t, v, s in written]


def test_a_training_run_writes_the_jax_tags_at_the_jax_steps(speaker_root, tmp_path):
    """Two epochs of 4 steps, a log line every step, validation each epoch:
    ``train/lr_optimizer`` and ``train/<loss>`` at global steps 1-8, the last
    step's values those the run returns; ``train/epoch_time`` and
    ``train/ETA`` and ``val/<metric>`` and the ``train/clip_code`` figure at
    epochs 1 and 2. A test run writes
    ``test/<metric>`` at step 0, the metrics it returns."""
    cfg = _cfg(speaker_root, str(tmp_path), "TRAIN.NUM_EPOCHS", "2", "SYS.LOG_INTERVAL", "1",
               "TRAIN.VALIDATE", "True")
    out = trainer.train(cfg, "tb", "cpu")
    events = _events(out["output_dir"])
    by_tag = {}
    for e in events:
        by_tag.setdefault(e["tag"], []).append((e["step"], e.get("value", e.get("png"))))
    # the epoch figure (JAX's draw_figure_epoch), the only image of the run
    assert [s for s, _ in by_tag.pop("train/clip_code")] == [1, 2]
    assert all("png" not in e for e in events if e["tag"] != "train/clip_code")
    for k, v in out["losses"].items():
        assert [s for s, _ in by_tag[f"train/{k}"]] == list(range(1, 9)), k
        assert by_tag[f"train/{k}"][-1][1] == np.float32(v), k
    assert [s for s, _ in by_tag["train/lr_optimizer"]] == list(range(1, 9))
    # 2 epochs: MultiStepLR's milestone N - 2 = 0 scales the rate from the first step
    assert by_tag["train/lr_optimizer"][0][1] == np.float32(cfg.TRAIN.LR * 0.1)
    for tag in ("train/epoch_time", "train/ETA"):
        assert [s for s, _ in by_tag[tag]] == [1, 2], tag
    assert by_tag["train/ETA"][-1][1] == 0.0
    for k, v in out["val_metrics"].items():
        assert [s for s, _ in by_tag[f"val/{k}"]] == [1, 2], k
        assert by_tag[f"val/{k}"][-1][1] == np.float32(v), k
    with open(os.path.join(out["output_dir"], "tb.log")) as f:
        assert f.read().count("[TRAIN] epoch_time: ") == 2

    tested = trainer.test(cfg, out["checkpoint"], "tbtest", "cpu")
    got = {e["tag"]: (e["step"], e["value"]) for e in _events(tested["output_dir"])}
    assert got == {f"test/{k}": (0, float(np.float32(v))) for k, v in tested["metrics"].items()}


def test_s2g_run_writes_the_discriminator_tags(speaker_root, tmp_path):
    """s2g: a log line at each of 2 steps writes ``train/lr_G`` and
    ``train/lr_D_pose`` (the JAX ``current_lrs`` names) and the D losses and
    scores beside the generator's, no clip-code KL."""
    from speechdrivestemplates_tpu_torch.config import s2g

    cfg = apply_overrides(s2g(precision="fp32"), [
        "DATASET.ROOT_DIR", speaker_root, "SYS.OUTPUT_DIR", str(tmp_path), "TRAIN.BATCH_SIZE",
        "2", "DATASET.SUBSET", "4", "TRAIN.NUM_EPOCHS", "1", "TRAIN.VALIDATE", "False",
        "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0", "SYS.LOG_INTERVAL", "1"])
    out = trainer.train(cfg, "s2g", "cpu")
    tags = {e["tag"]: [] for e in _events(out["output_dir"])}
    for e in _events(out["output_dir"]):
        tags[e["tag"]].append(e["step"])
    for k in ("lr_G", "lr_D_pose", "G_reg_loss", "G_pose_gan_loss", "G_loss", "D_pose_gan_loss",
              "pose_score_fake", "pose_score_real", "L2_dist"):
        assert tags[f"train/{k}"] == [1, 2], k
    assert "train/lr_ClipCode" not in tags and "train/G_clipcode_kl_loss" not in tags


def test_profile_window_writes_a_chrome_trace(speaker_root, tmp_path):
    """SYS.PROFILE over global steps [2, 4) of a 4-step epoch: one window,
    opened at step 2 and closed before step 4, its trace a JSON file under
    ``<run>/profile``."""
    cfg = _cfg(speaker_root, str(tmp_path), "TRAIN.NUM_EPOCHS", "1", "TRAIN.VALIDATE", "False",
               "SYS.PROFILE.ENABLED", "True", "SYS.PROFILE.START_STEP", "2",
               "SYS.PROFILE.NUM_STEPS", "2")
    out = trainer.train(cfg, "prof", "cpu")
    traces = glob.glob(os.path.join(out["output_dir"], "profile", "*.json"))
    assert [os.path.basename(t) for t in traces] == ["trace_steps-2-3.json"]
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def _summaries(kind, w):
    rng = np.random.RandomState(11)
    if kind == "image_chw_float":
        w.add_image("img", rng.rand(3, 20, 30).astype(np.float32), 4)
    elif kind == "image_hwc_uint8":
        w.add_image("img", rng.randint(0, 256, (20, 30, 3), dtype=np.uint8), 5,
                    dataformats="HWC")
    elif kind == "figure":
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig = plt.figure()
        plt.scatter(rng.randn(50), rng.randn(50), s=1)
        w.add_figure("train/clip_code", fig, 7)
    else:
        w.add_video("val/video/1", rng.rand(1, 5, 3, 18, 32).astype(np.float32), 2, fps=15)
    w.add_scalar("a", 1.5, 3)


@pytest.mark.parametrize("kind", ["image_chw_float", "image_hwc_uint8", "figure", "video"])
def test_image_figure_and_video_payloads_equal_the_jax_writer(tmp_path, kind):
    files = {}
    for name, mod in (("jax", jax_tb), ("port", tb_native)):
        w = mod.NativeTBWriter(str(tmp_path / name))
        _summaries(kind, w)
        w.close()
        files[name] = glob.glob(str(tmp_path / name / "events.*"))[0]
    got, want = jax_tb.read_events(files["port"]), jax_tb.read_events(files["jax"])
    assert got == want and len(got) == 2 and "png" in got[0]
    assert tb_native.read_events(files["port"]) == got
    payload = got[0]["png"]
    if kind == "video":
        frames = tb_native.gif_decode(payload)
        assert frames.shape == (5, 18, 32, 3)
        np.testing.assert_array_equal(frames, jax_tb.gif_decode(payload))
    else:
        assert payload.startswith(b"\x89PNG")


@pytest.mark.parametrize("shape", [(0,), (64, 64), (300, 300), (9, 2000)],
                         ids=["empty", "small", "table-resets", "runs"])
def test_gif_lzw_equals_the_jax_encoder(shape):
    """The port's int-keyed LZW emits the JAX encoder's bytes, through the
    table's resets at 4096 codes and over long runs."""
    rng = np.random.RandomState(12)
    idx = rng.randint(0, 252, shape).astype(np.uint8)
    if shape == (9, 2000):
        idx[:, 100:1900] = 251
    assert tb_native._gif_lzw(idx) == jax_tb._gif_lzw(idx)
    assert tb_native._png_encode(np.zeros((4, 5, 3), np.uint8)) == \
        jax_tb._png_encode(np.zeros((4, 5, 3), np.uint8))


def test_writes_from_two_threads_are_whole_records(tmp_path):
    import threading

    w = tb_native.NativeTBWriter(str(tmp_path))
    vid = np.random.RandomState(13).rand(1, 3, 3, 30, 40).astype(np.float32)
    t = threading.Thread(target=lambda: [w.add_video("v", vid, i) for i in range(20)])
    t.start()
    for i in range(200):
        w.add_scalar("s", i, i)
    t.join()
    w.close()
    got = jax_tb.read_events(w.path)  # CRC-checked record by record
    assert sum("png" in e for e in got) == 20 and sum("value" in e for e in got) == 200


def test_runs_with_videos_write_the_jax_image_tags(speaker_root, tmp_path):
    """TRAIN.SAVE_VIDEO and TEST.SAVE_VIDEO into TensorBoard, 2 epochs of 4
    steps, TRAIN.NUM_RESULT_SAMPLE 2: ``train/video`` at global steps 2, 4,
    6, 8, ``val/video/<step>`` at each epoch, ``train/clip_code`` at epochs 1
    and 2; a test run writes ``test/video/1`` and ``test/video/2`` at step
    0, GIFs of 64 frames at 0.4x the canvas."""
    opts = ["TRAIN.NUM_EPOCHS", "2", "TRAIN.VALIDATE", "True", "TRAIN.SAVE_VIDEO", "True",
            "TEST.SAVE_VIDEO", "True", "SYS.VIDEO_FORMAT", "['tensorboard']",
            "SYS.CANVAS_SIZE", "(100, 160)"]
    cfg = _cfg(speaker_root, str(tmp_path), *opts)
    out = trainer.train(cfg, "vid", "cpu")
    images = sorted((e["tag"], e["step"]) for e in _events(out["output_dir"]) if "png" in e)
    assert images == sorted([("train/clip_code", 1), ("train/clip_code", 2)]
                            + [("train/video", s) for s in (2, 4, 6, 8)]
                            + [(f"val/video/{t}", e) for t in (1, 2) for e in (1, 2)])
    tested = trainer.test(cfg, out["checkpoint"], "vidtest", "cpu")
    videos = [e for e in _events(tested["output_dir"]) if "png" in e]
    assert [(e["tag"], e["step"]) for e in videos] == [("test/video/1", 0), ("test/video/2", 0)]
    assert tb_native.gif_decode(videos[0]["png"]).shape == (64, 40, 64, 3)
    assert not os.path.exists(os.path.join(tested["output_dir"], "videos"))
