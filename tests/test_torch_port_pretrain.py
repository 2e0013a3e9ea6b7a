"""``--pretrain_from`` (TRAIN.PRETRAIN_FROM) in the port's trainer, on the CPU:
weights only, fresh optimizers, a new run directory, the bank-row check; a
JAX export (``utils/torch_export.py``) pretrains the port, whose first step
matches the JAX pipeline's first step from the same ``.pth``."""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch import main as port_main
from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, sdt_bp
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.pipelines import checkpoint as C
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines.pose2pose import Pose2PoseTrainState, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrain") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=0, seed=6)
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU steps run fastest on one intra-op thread, and the suite runs
    several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _opts(root, out, *extra):
    return ["DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", str(out), "TRAIN.BATCH_SIZE", "2",
            "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0", *extra]


def _cfg(preset, root, out, *extra):
    return apply_overrides(preset(precision="fp32"), _opts(root, out, *extra))


def test_pretrain_takes_weights_with_fresh_optimizers_in_a_new_directory(
        speaker_root, tmp_path, capsys):
    """``--pretrain_from`` a port checkpoint: a new run directory, the first
    step taken from the checkpoint's weights and banks (the step's loss
    equals one taken by hand from the loaded .pth), Adams that start at step
    0, and a bank of another size refused."""
    cfg = _cfg(pose2pose, speaker_root, tmp_path, "TRAIN.NUM_EPOCHS", "1",
               "TRAIN.VALIDATE", "False")
    first = trainer.train(cfg, "base", "cpu")
    argv = ["--device", "cpu", "--config_file", "configs/pose2pose.yaml", "--tag", "pre",
            "--pretrain_from", first["checkpoint"],
            *_opts(speaker_root, tmp_path, "TRAIN.NUM_EPOCHS", "1", "TRAIN.VALIDATE", "False",
                   "SYS.LOG_INTERVAL", "1")]
    out = port_main.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 2
    assert out["output_dir"] != first["output_dir"] and "resumed_from" not in out
    assert len(os.listdir(os.path.join(first["output_dir"], "checkpoints"))) == 2
    resume = torch.load(C.resume_path(out["checkpoint"]), weights_only=True)
    assert all(float(s["step"]) == 2 for s in resume["optimizers"][0]["state"].values())

    by_hand = Pose2PoseTrainState(cfg, 4, "cpu")
    by_hand.load_pth(first["checkpoint"])
    loader = trainer.train_loader(cfg)
    loader.batch_sampler.set_epoch(1)
    losses, _ = train_step(by_hand, next(iter(loader)))
    with open(os.path.join(out["output_dir"], "pose2pose-TRAIN-pre.log")) as f:
        line = next(ln for ln in f if "global_step: 1 " in ln)
    assert f"loss: {float(losses['loss']):.5f}" in line

    other = str(tmp_path / "speakers6")
    make_synthetic_speaker(other, "oliver", num_train=6, num_dev=0, seed=6)
    with pytest.raises(ValueError, match="clip-code bank has 4 rows but the train split has 6"):
        trainer.train(apply_overrides(_cfg(pose2pose, other, tmp_path, "TRAIN.VALIDATE",
                                           "False"), ["TRAIN.PRETRAIN_FROM", first["checkpoint"]]),
                      "six", "cpu")


def test_pretrain_from_a_jax_export_matches_the_jax_first_step(tmp_path):
    """A .pth written by the JAX package (``export_voice2pose`` +
    ``save_torch_checkpoint``, a random bank so the KL is on) pretrains the
    port; the port's first step (its TensorBoard scalars at global step 1)
    equals the JAX pipeline's first step from the same .pth, on the same
    batch, within rtol 1e-4 (fp32, the gate of tests/test_torch_port_train.py);
    ``--resume_from`` of it is refused."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.datasets.synthetic import make_synthetic_speaker as jax_spk
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu.utils import tb_native as jax_tb
    from speechdrivestemplates_tpu.utils.torch_export import (export_voice2pose,
                                                              save_torch_checkpoint)

    root = str(tmp_path / "speakers")
    jax_spk(root, "oliver", num_train=8, num_dev=0)
    jcfg = get_cfg_defaults()
    jcfg.merge_from_file(os.path.join(ROOT, "configs", "voice2pose_sdt_bp.yaml"))
    jcfg.DATASET.SPEAKER, jcfg.DATASET.ROOT_DIR = "oliver", root
    jcfg.TRAIN.BATCH_SIZE, jcfg.TRAIN.VALIDATE, jcfg.TRAIN.SAVE_VIDEO = 4, False, False
    jcfg.TRAIN.LR_SCHEDULER, jcfg.SYS.MESH.DATA = False, 1
    jcfg.freeze()
    pipe = get_pipeline(jcfg.PIPELINE_TYPE)(jcfg)
    pipe.setup_dataset(jcfg, "train")
    pipe.setup_model(jcfg)
    state0 = jax.device_get(pipe.state)
    state0["clips_code"] = np.random.RandomState(1).randn(8, 32).astype(np.float32)
    pth = str(tmp_path / "jax_export.pth")
    save_torch_checkpoint(pth, export_voice2pose(state0), epoch=5, step=10)

    pipe.load_torch_pth(pth)
    pipe.setup_optimizer()
    pipe.train_dataloader.set_epoch(1)
    jb = next(iter(pipe.train_dataloader))
    _, jl, _ = pipe._get_train_step()(pipe.state, pipe._device_batch(jb), jax.random.PRNGKey(0))
    jl = {k: float(v) for k, v in jl.items()}

    opts = ["DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", str(tmp_path / "runs"),
            "TRAIN.BATCH_SIZE", "4", "TRAIN.LR_SCHEDULER", "False", "TRAIN.VALIDATE", "False",
            "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0", "SYS.LOG_INTERVAL", "1",
            "TRAIN.NUM_EPOCHS", "1"]
    cfg = apply_overrides(sdt_bp(precision="fp32"), opts + ["TRAIN.PRETRAIN_FROM", pth])
    out = trainer.train(cfg, "from_jax", "cpu")
    events = jax_tb.read_events(glob.glob(os.path.join(out["output_dir"], "events.*"))[0])
    first = {e["tag"][len("train/"):]: e["value"] for e in events
             if e["step"] == 1 and "value" in e}  # the scalars, not the epoch figure
    assert jl["G_clipcode_kl_loss"] > 0
    for k in ("G_reg_loss", "G_clipcode_kl_loss", "G_loss", "L2_dist", "lip_sync_error_n"):
        np.testing.assert_allclose(first[k], jl[k], rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="--pretrain_from"):
        trainer.train(apply_overrides(sdt_bp(precision="fp32"), list(opts)), "r", "cpu",
                      resume_from=pth)
