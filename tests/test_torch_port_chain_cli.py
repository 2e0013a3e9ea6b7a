"""The paper's chain through the port's command line on the CPU:
``main --config_file configs/pose2pose.yaml``, then SDT-BP with that
checkpoint's encoder as the frozen FGD encoder and TRAIN.VALIDATE, then
``--test_only --checkpoint`` of the SDT-BP checkpoint, then SDT-VAE on the
Pose2Pose bank. Each run ends with its JSON line."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch import main as port_main
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.utils.weights import read_pth


def _run(capsys, *argv):
    summary = port_main.main(["--device", "cpu", *argv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(summary))
    return line


def test_pose2pose_sdt_bp_test_only_sdt_vae(tmp_path, capsys):
    root = str(tmp_path / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=3, seed=1)
    common = ["DATASET.ROOT_DIR", root, "TRAIN.NUM_EPOCHS", "2", "TRAIN.BATCH_SIZE", "2",
              "TEST.BATCH_SIZE", "2", "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False",
              "TRAIN.PRECISION", "fp32", "SYS.NUM_WORKERS", "0", "SYS.LOG_INTERVAL", "1"]
    out = str(tmp_path / "runs")

    p2p = _run(capsys, "--config_file", "configs/pose2pose.yaml", "--tag", "p2p", *common,
               "TRAIN.VALIDATE", "False", "SYS.OUTPUT_DIR", out)
    assert p2p["steps"] == 4 and set(p2p["losses"]) >= {"reg_loss", "kl_loss", "L2_dist"}
    ae = p2p["checkpoint"]
    assert os.path.basename(ae) == "checkpoint_epoch-2_step-4.pth"
    ae_sd = read_pth(ae)
    assert ae_sd["clip_code_mu"].shape == (4, 32) and ae_sd["clip_code_mu"].abs().min() > 0

    gt_code = ["VOICE2POSE.GENERATOR.CLIP_CODE.TEST_WITH_GT_CODE", "True"]
    bp = _run(capsys, "--config_file", "configs/voice2pose_sdt_bp.yaml", "--tag", "bp",
              *common, *gt_code, "TRAIN.VALIDATE", "True", "SYS.OUTPUT_DIR", out,
              "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae)
    assert bp["steps"] == 4
    val = bp["val_metrics"]  # the last epoch's validation
    assert {"L2_dist", "lip_sync_error_n", "FGD_mu", "FGD_mu_logvar"} <= set(val)
    with open(glob.glob(os.path.join(bp["output_dir"], "voice2pose_sdt_bp-TRAIN-bp.log"))[0]) as f:
        assert f.read().count("val_time:") == 2  # a validation an epoch (CHECKPOINT_INTERVAL 1)
    assert sorted(os.listdir(os.path.join(bp["output_dir"], "results"))) == [
        f"epoch{e}-VAL-step{s}.npz" for e in (1, 2) for s in (1, 2)]

    test = _run(capsys, "--config_file", "configs/voice2pose_sdt_bp.yaml", "--test_only",
                "--checkpoint", bp["checkpoint"], "--tag", "test", *common, *gt_code,
                "SYS.OUTPUT_DIR", out, "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae)
    assert test["num_samples"] == 3
    for k in ("L2_dist", "lip_sync_error_n", "FGD_mu", "FGD_mu_logvar"):
        assert np.isfinite(test["metrics"][k]), k
        # the test run of the last checkpoint is that epoch's validation
        np.testing.assert_allclose(test["metrics"][k], val[k], rtol=1e-6, err_msg=k)
    with np.load(os.path.join(test["output_dir"], "results", "epoch0-TEST-step1.npz")) as z:
        assert z["poses_pred_batch"].shape == (2, 64, 2, 121) and z["mu_gt"].shape == (2, 32)

    vae = _run(capsys, "--config_file", "configs/voice2pose_sdt_vae.yaml", "--tag", "vae",
               *common, "TRAIN.VALIDATE", "False", "SYS.OUTPUT_DIR", out,
               "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae)
    vae_sd = read_pth(vae["checkpoint"])
    torch.testing.assert_close(vae_sd["clips_code"], ae_sd["clip_code_mu"], rtol=0, atol=0)
    assert set(vae["losses"]) >= {"G_reg_loss", "G_clipcode_kl_loss"}


def test_cli_refuses_what_it_lacks(tmp_path):
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--test_only"])  # no --checkpoint
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--checkpoint", "x.pth"])  # without --test_only
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--config_file", "configs/other.yaml"])
    # parallel keys that map onto no ranks (item 14 is ported: the keys themselves are
    # accepted), refused before anything is written
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--config_file", "configs/voice2pose_s2g.yaml",
                        "SYS.OUTPUT_DIR", str(tmp_path), "SYS.WORLD_SIZE", "0"])
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--test_only", "--checkpoint", "x.pth",
                        "SYS.OUTPUT_DIR", str(tmp_path), "SYS.MESH.DATA", "4"])
    assert not os.listdir(tmp_path)


def test_s2g_train_test_resume_serve(tmp_path, capsys):
    """s2g-GAN through the command line: ``--config_file
    configs/voice2pose_s2g.yaml`` trains 2 epochs with a validation each,
    ``--test_only`` of its checkpoint gives the four test metrics,
    ``--resume_from`` its epoch-1 checkpoint trains the last epoch again to
    the same weights, and the serving command line with the same
    ``--config_file`` serves a wav from it without a code."""
    import wave

    from speechdrivestemplates_tpu_torch import serving

    root = str(tmp_path / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=2, num_dev=2, seed=2)
    out = str(tmp_path / "runs")
    common = ["--config_file", "configs/voice2pose_s2g.yaml", "DATASET.ROOT_DIR", root,
              "SYS.OUTPUT_DIR", out, "TRAIN.NUM_EPOCHS", "2", "TRAIN.BATCH_SIZE", "2",
              "TEST.BATCH_SIZE", "2", "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False",
              "TRAIN.PRECISION", "fp32", "SYS.NUM_WORKERS", "0"]
    run = _run(capsys, "--tag", "s2g", *common, "TRAIN.VALIDATE", "True")
    assert run["steps"] == 2 and {"G_pose_gan_loss", "D_pose_gan_loss"} <= set(run["losses"])
    assert "G_clipcode_kl_loss" not in run["losses"] and np.isfinite(run["val_metrics"]["FGD_mu"])
    sd = read_pth(run["checkpoint"])
    assert "clips_code" not in sd and any(k.startswith("netD_pose.") for k in sd)

    test = _run(capsys, "--test_only", "--checkpoint", run["checkpoint"], "--tag", "t", *common)
    for k in ("L2_dist", "lip_sync_error_n", "FGD_mu", "FGD_mu_logvar"):
        assert np.isfinite(test["metrics"][k]), k
    np.testing.assert_allclose(test["metrics"]["L2_dist"], run["val_metrics"]["L2_dist"],
                               rtol=1e-6)

    first = glob.glob(os.path.join(run["output_dir"], "checkpoints", "*epoch-1_*.pth"))[0]
    again = _run(capsys, "--tag", "s2g", "--resume_from", first, *common,
                 "TRAIN.VALIDATE", "True")
    assert again["checkpoint"] == run["checkpoint"] and again["losses"] == run["losses"]
    assert all(torch.equal(v, sd[k]) for k, v in read_pth(again["checkpoint"]).items())

    wav = str(tmp_path / "in.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.RandomState(3).randn(40000) * 3000).astype(np.int16).tobytes())
    poses = str(tmp_path / "poses.npz")
    serving.main([run["checkpoint"], wav, poses, "--config_file",
                  "configs/voice2pose_s2g.yaml", "--device", "cpu"])
    with np.load(poses) as z:
        assert z["poses"].shape == (64, 2, 121) and np.isfinite(z["poses"]).all()
    with pytest.raises(RuntimeError, match="Unexpected key"):  # an s2g .pth is no SDT-BP model
        serving.main([run["checkpoint"], wav, poses, "--device", "cpu"])


def test_chain_script_runs_its_stages(tmp_path, capsys):
    """``chain_e2e``, the chain at ``bench_e2e.py``'s budget, at a tiny one:
    each stage one command-line process, its JSON line with the wall time and
    the loop's steps/s, its checkpoint and log kept; the acceptance bands are
    read only at the reference budget."""
    from speechdrivestemplates_tpu_torch import chain_e2e

    keep, out = str(tmp_path / "keep"), str(tmp_path / "chain")
    small = ["--device", "cpu", "--out", out, "--keep", keep, "--train", "4", "--dev", "3",
             "--epochs", "1", "--batch", "2"]
    lines = {}
    for stage in ("pose2pose", "sdt_bp", "test"):
        lines[stage] = chain_e2e.main([stage, *small, "--ae", os.path.join(keep, "pose2pose.pth"),
                                       "--bp", os.path.join(keep, "sdt_bp.pth")])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed["stage"] == stage and printed["wall_s"] > 0
    assert lines["pose2pose"]["steps"] == 2 and lines["sdt_bp"]["steps_per_s"] > 0
    assert lines["sdt_bp"]["summary"]["val_metrics"]["FGD_mu"] > 0
    assert sorted(os.listdir(keep)) == ["pose2pose.log", "pose2pose.pth", "sdt_bp.log",
                                        "sdt_bp.pth", "test.log"]
    assert "acceptance" not in lines["test"] and lines["test"]["summary"]["num_samples"] == 3
    with pytest.raises(SystemExit):
        chain_e2e.main(["sdt_vae", "--device", "cpu"])  # needs --ae
