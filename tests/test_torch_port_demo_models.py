"""The demo of the other models against the JAX package's, on the CPU, each
from one seeded ``.pth`` that both load: s2g-GAN's dense demo (its BN
generator, with running statistics moved by training, against JAX's bucketed
and exact-length demos), SDT-VAE's on
its external bank, and Pose2Pose's decode of DEMO.CODE_PATH's codes through
the whole demo run, DEMO.MULTIPLE 3."""

import glob
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, s2g, sdt_vae
from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
from speechdrivestemplates_tpu_torch.models.blocks import BatchNorm
from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram_plain
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines import voice2pose as V
from speechdrivestemplates_tpu_torch.pipelines.pose2pose import Pose2PoseTrainState

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
COMMON = ["TEST.SAVE_VIDEO", "False", "TRAIN.PRECISION", "fp32"]
PX_ATOL = 0.01  # px: the bound of tests/test_demo_bucketing.py


def _jax_pipe(yaml, ckpt, *opts):
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, yaml))
    cfg.merge_from_list(["DATASET.SPEAKER", "oliver", "SYS.MESH.DATA", "1", *COMMON, *opts])
    cfg.freeze()
    pipe = get_pipeline(cfg.PIPELINE_TYPE)(cfg)
    pipe.num_train_samples = None  # the demo's: the checkpoint's bank rows
    pipe._load_model_weights(ckpt)
    return pipe


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo_models")
    rng = np.random.RandomState(0)
    t = np.arange(int(5.1 * 16000)) / 16000
    x = 0.1 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t)) + 0.02 * rng.randn(
        len(t))
    wavfile.write(str(tmp / "clip.wav"), 16000, (x * 32767).astype(np.int16))
    return tmp


@pytest.fixture(scope="module")
def ae_ckpt(tmp):
    """A Pose2Pose .pth: seeded weights, BN statistics and banks drawn."""
    state = Pose2PoseTrainState(apply_overrides(pose2pose(), list(COMMON)), 6, "cpu")
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for m in state.ae.modules():
            if isinstance(m, BatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.2))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)))
        state.clip_code_mu.copy_(torch.from_numpy(rng.randn(6, 32).astype(np.float32)))
    path = str(tmp / "ae.pth")
    state.save_checkpoint(path, 1, 1)
    return path


def _demo_batches(pipe, tmp, cfg):
    wav = str(tmp / "clip.wav")
    pipe.setup_dataset(pipe.cfg, "demo", demo_input=wav)
    jb = next(iter(pipe.test_dataloader))
    pb = collate([GestureDataset("unused", "oliver", cfg, split="demo", demo_input=wav)[0]])
    np.testing.assert_array_equal(pb["audio"].numpy(), np.asarray(jb["audio"]))
    for k in jb["speaker_stat"]:
        np.testing.assert_array_equal(pb["speaker_stat"][k].numpy(),
                                      np.asarray(jb["speaker_stat"][k]))
    return pb, jb


def _assert_demo_equal(got, want, frames, rtol=0.0):
    p, w = got["poses_pred_batch"].numpy(), np.asarray(want["poses_pred_batch"])
    assert p.shape == w.shape == (1, frames, 2, 121)
    np.testing.assert_allclose(p, w, rtol=rtol, atol=PX_ATOL)


@pytest.mark.parametrize("bucket_s", [2.0, 0.0], ids=["bucketed", "exact"])
def test_s2g_dense_demo_matches_jax(tmp, bucket_s):
    """The code-less BN generator on global poses, at the clip's own length,
    against JAX's demo bucketed (each BN layer with its running statistics,
    the padded frames re-zeroed, trimmed) or not. The seeded generator's
    global poses reach ~2,600 px, where fp32 round-off (~5e-6 relative,
    measured) passes 0.01 px: held at 0.01 px + 2e-5 relative."""
    cfg = apply_overrides(s2g(), [*COMMON, "DEMO.LENGTH_BUCKET_S", str(bucket_s)])
    state = V.Voice2PoseTrainState(cfg, 4, "cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():  # BN statistics moved by train-mode forwards on audio-like mels
        for _ in range(2):
            state.generator(mel_spectrogram_plain(torch.randn(3, 68266, generator=g) * 0.1),
                            64, None)
    ckpt = str(tmp / f"s2g_{bucket_s}.pth")
    state.save_checkpoint(ckpt, 1, 1)
    pipe = _jax_pipe("voice2pose_s2g.yaml", ckpt, "DEMO.LENGTH_BUCKET_S", str(bucket_s))
    port = V.Voice2PoseTrainState(cfg, None, "cpu")
    port.load_pth(ckpt)
    pb, jb = _demo_batches(pipe, tmp, cfg)
    got = V.demo_step(port, pb)
    assert set(got) == {"poses_pred_batch"}
    _assert_demo_equal(got, pipe._dense_demo_forward(jb, 76, None), 76, rtol=2e-5)


def test_sdt_vae_dense_demo_matches_jax(tmp, ae_ckpt):
    """The frozen external bank (the Pose2Pose checkpoint's clip_code_mu),
    row 2 moved half way to row 5, at the clip's own length against JAX's
    demo with its default length bucket."""
    opts = [*COMMON, "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_ckpt, "DEMO.CODE_INDEX", "2",
            "DEMO.CODE_INDEX_B", "5"]
    cfg = apply_overrides(sdt_vae(), list(opts))
    state = V.Voice2PoseTrainState(cfg, 6, "cpu")
    ckpt = str(tmp / "vae.pth")
    state.save_checkpoint(ckpt, 1, 1)
    port = V.Voice2PoseTrainState(cfg, None, "cpu")
    port.load_pth(ckpt)
    pipe = _jax_pipe("voice2pose_sdt_vae.yaml", ckpt, *opts[4:])
    pb, jb = _demo_batches(pipe, tmp, cfg)
    got = V.demo_step(port, pb, 0.5)
    want = pipe._dense_demo_forward(jb, 76, 0.5)
    _assert_demo_equal(got, want, 76)
    np.testing.assert_allclose(got["condition_code"].numpy(),
                               np.asarray(want["condition_code"]), rtol=1e-6)


def test_pose2pose_code_path_demo_matches_jax(tmp, ae_ckpt):
    """``trainer.demo`` of Pose2Pose against the JAX demo run: three passes
    decode rows 0, 1, 2 of DEMO.CODE_PATH's "v" (times 10) into
    ``epoch0-DEMO-step1-{i}.npz``."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    code_path = str(tmp / "codes.npz")
    np.savez(code_path, v=np.random.RandomState(3).randn(3, 32))  # float64, as saved by hand
    wav = str(tmp / "clip.wav")
    opts = [*COMMON, "DEMO.CODE_PATH", code_path, "DEMO.MULTIPLE", "3"]
    out = trainer.demo(apply_overrides(pose2pose(), [*opts, "SYS.OUTPUT_DIR",
                                                     str(tmp / "port")]),
                       ae_ckpt, wav, "p2p", "cpu")
    jcfg = get_cfg_defaults()
    jcfg.merge_from_file(os.path.join(CONFIG_DIR, "pose2pose.yaml"))
    jcfg.merge_from_list(["DATASET.SPEAKER", "oliver", "SYS.MESH.DATA", "1", *opts,
                          "SYS.OUTPUT_DIR", str(tmp / "jax")])
    jcfg.freeze()
    get_pipeline("Pose2Pose")(jcfg).demo(jcfg, "p2p", ae_ckpt, wav)
    want = sorted(glob.glob(str(tmp / "jax" / "*" / "results" / "*.npz")))
    assert [os.path.basename(p) for p in out["npz"]] == [os.path.basename(p) for p in want] \
        == [f"epoch0-DEMO-step1-{i}.npz" for i in range(3)]
    for i, (p, w) in enumerate(zip(out["npz"], want)):
        with np.load(p) as zp, np.load(w) as zw:
            assert sorted(zp.files) == sorted(zw.files)
            assert zp["poses_pred_batch"].shape == (1, 64, 2, 121)
            np.testing.assert_allclose(zp["poses_pred_batch"], zw["poses_pred_batch"], rtol=0,
                                       atol=PX_ATOL)
            np.testing.assert_array_equal(zp["clip_code_mu"], zw["clip_code_mu"])
            np.testing.assert_array_equal(zp["clip_code_mu"][0], np.float32(
                np.load(code_path)["v"][i] * 10))
            assert not zp["clip_code_logvar"].any()


def test_pose2pose_demo_needs_a_code_path(tmp, ae_ckpt):
    with pytest.raises(ValueError, match="DEMO.CODE_PATH"):
        trainer.demo(apply_overrides(pose2pose(), [*COMMON, "SYS.OUTPUT_DIR",
                                                   str(tmp / "none")]),
                     ae_ckpt, str(tmp / "clip.wav"), "p2p", "cpu")
    assert not (tmp / "none").exists()
