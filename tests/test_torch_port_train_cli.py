"""The port's training entry point on the CPU, end to end: a synthetic
speaker from the port's own writer, ``python -m speechdrivestemplates_tpu_torch.main
--device cpu`` for one epoch, its checkpoint, and the serving command line
serving a wav from that checkpoint."""

import glob
import json
import os
import wave

import numpy as np
import torch

from speechdrivestemplates_tpu_torch import main as train_main
from speechdrivestemplates_tpu_torch import serving
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker


def test_cpu_training_writes_a_checkpoint_that_serving_serves(tmp_path, capsys):
    root = str(tmp_path / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=1, seed=2)
    out_dir = str(tmp_path / "runs")
    summary = train_main.main([
        "--device", "cpu", "--tag", "cli", "DATASET.ROOT_DIR", root,
        "SYS.OUTPUT_DIR", out_dir, "TRAIN.NUM_EPOCHS", "1", "TRAIN.BATCH_SIZE", "2",
        "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False",
        "TRAIN.PRECISION", "fp32", "SYS.LOG_INTERVAL", "1", "SYS.NUM_WORKERS", "0"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(summary))
    assert line["steps"] == 2 and line["epochs"] == 1
    assert all(np.isfinite(v) for v in line["losses"].values())
    ckpt = line["checkpoint"]
    assert ckpt == glob.glob(os.path.join(out_dir, "*_voice2pose_sdt_bp-TRAIN-cli", "checkpoints",
                                          "*.pth"))[0]
    assert os.path.basename(ckpt) == "checkpoint_epoch-1_step-2.pth"
    log = glob.glob(os.path.join(out_dir, "*_voice2pose_sdt_bp-TRAIN-cli",
                                 "voice2pose_sdt_bp-TRAIN-cli.log"))[0]
    with open(log) as f:
        assert f.read().count("[TRAIN] epoch: 1/1  step:") == 2

    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    msd = state["model_state_dict"]
    assert (state["epoch"], state["step"]) == (1, 2)
    assert tuple(msd["module.clips_code"].shape) == (4, 32)
    assert msd["module.clips_code"].abs().sum() > 0  # the bank moved off zero
    assert int(msd["module.pose_encoder.blocks.0.norm.num_batches_tracked"]) == 4

    wav_path = str(tmp_path / "in.wav")
    pcm = (np.random.RandomState(1).randn(30000) * 3000).astype(np.int16)
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    out = str(tmp_path / "poses.npz")
    serving.main([ckpt, wav_path, out, "--device", "cpu"])
    with np.load(out) as z:
        poses = z["poses"]
    assert poses.shape == (64, 2, 121) and np.isfinite(poses).all()
