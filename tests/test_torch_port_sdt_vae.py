"""SDT-VAE (a frozen external template bank) and per-frame codes
(CLIP_CODE.FRAME_VARIANT) in the port's Voice2Pose train step, against the JAX
package's, on the CPU: two steps of each pipeline from the same weights on the
same batches (8-clip synthetic speaker, batch 4, full width, fp32)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, sdt_bp, sdt_vae
from speechdrivestemplates_tpu_torch.pipelines.pose2pose import Pose2PoseTrainState
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                 train_step)
from speechdrivestemplates_tpu_torch.utils.weights import state_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
STEPS = 2


def _port_opts(root, *extra):
    return ["DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4",
            "TRAIN.LR_SCHEDULER", "False", "TRAIN.VALIDATE", "False",
            "TRAIN.SAVE_VIDEO", "False", *extra]


def _jax_pipe(root, yaml, *opts):
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, yaml))
    cfg.merge_from_list(["DATASET.ROOT_DIR", root, "DATASET.SPEAKER", "oliver",
                         "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False",
                         "TRAIN.SAVE_VIDEO", "False", "TRAIN.LR_SCHEDULER", "False",
                         "SYS.MESH.DATA", "1", *opts])
    cfg.freeze()
    pipe = get_pipeline("Voice2Pose")(cfg)
    pipe.setup_dataset(cfg, "train")
    pipe.setup_model(cfg)
    pipe.setup_optimizer()
    return pipe


def _two_steps(pipe, port):
    """Both pipelines' first STEPS steps on the same batches: per step, each
    side's losses; then each side's bank."""
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    loader = train_loader(port.cfg)
    loader.batch_sampler.set_epoch(1)
    pipe.train_dataloader.set_epoch(1)
    step_fn, key = pipe._get_train_step(), jax.random.PRNGKey(0)
    out = {"jax": [], "ported": []}
    for jb, tb in zip(pipe.train_dataloader, loader):
        np.testing.assert_array_equal(tb["clip_index"].numpy(), jb["clip_index"])
        key, sub = jax.random.split(key)
        pipe.state, jl, _ = step_fn(pipe.state, pipe._device_batch(jb), sub)
        tl, _ = train_step(port, tb)
        out["jax"].append({k: float(v) for k, v in jl.items()})
        out["ported"].append({k: float(v) for k, v in tl.items()})
    assert len(out["ported"]) == STEPS
    out["jax_bank"] = np.asarray(jax.device_get(pipe.state["clips_code"]))
    return out


@pytest.fixture(scope="module")
def speaker(tmp_path_factory):
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker

    tmp = tmp_path_factory.mktemp("vae")
    root = str(tmp / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=0, seed=6)
    # a Pose2Pose checkpoint whose bank is random: SDT-VAE's templates
    ae = Pose2PoseTrainState(apply_overrides(pose2pose(), _port_opts(root)), 8, "cpu")
    rng = np.random.RandomState(2)
    ae.clip_code_mu = torch.from_numpy(rng.randn(8, 32).astype(np.float32))
    ae.clip_code_logvar = torch.from_numpy(rng.randn(8, 32).astype(np.float32) * 0.1)
    ckpt = str(tmp / "ae.pth")
    ae.save_checkpoint(ckpt, 1, 1)
    return root, ckpt, ae.clip_code_mu.clone()


@pytest.fixture(scope="module")
def vae_run(speaker):
    root, ckpt, bank = speaker
    pipe = _jax_pipe(root, "voice2pose_sdt_vae.yaml",
                     "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ckpt)
    cfg = apply_overrides(sdt_vae(precision="fp32"), _port_opts(
        root, "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ckpt))
    port = Voice2PoseTrainState(cfg, 8, "cpu")
    torch.testing.assert_close(port.clips_code, bank, rtol=0, atol=0)  # loaded from the .pth
    port.load(state_from_jax(jax.device_get(pipe.state)))
    return dict(bank=bank, port=port, **_two_steps(pipe, port))


def test_external_bank_is_frozen_and_has_no_optimizer(vae_run):
    port = vae_run["port"]
    assert port.opt_code is None and set(port.learning_rates()) == {"G"}
    assert not port.clips_code.requires_grad
    torch.testing.assert_close(port.clips_code, vae_run["bank"], rtol=0, atol=0)
    np.testing.assert_array_equal(vae_run["jax_bank"], vae_run["bank"].numpy())


@pytest.mark.parametrize("step", range(STEPS))
def test_external_bank_steps_match_jax(vae_run, step):
    """The bank's codes are the same on both sides at every step, so the KL
    is held at rtol 1e-5 throughout; the L1 at 1e-4 at step 1 (same weights)
    and 1e-3 at step 2 (after each side's own Adam update)."""
    jl, tl = vae_run["jax"][step], vae_run["ported"][step]
    assert jl["G_clipcode_kl_loss"] > 0
    np.testing.assert_allclose(tl["G_clipcode_kl_loss"], jl["G_clipcode_kl_loss"], rtol=1e-5)
    np.testing.assert_allclose(tl["G_reg_loss"], jl["G_reg_loss"], rtol=(1e-4, 1e-3)[step])


@pytest.fixture(scope="module")
def frame_run(speaker):
    """SDT-BP with per-frame codes, both banks set to the same random values
    (a zero bank skips the KL)."""
    root, _, _ = speaker
    pipe = _jax_pipe(root, "voice2pose_sdt_bp.yaml",
                     "VOICE2POSE.GENERATOR.CLIP_CODE.FRAME_VARIANT", "True")
    bank = (np.random.RandomState(3).randn(8, 32, 64) * 0.5).astype(np.float32)
    pipe.state = dict(pipe.state, clips_code=jnp.asarray(bank))
    cfg = apply_overrides(sdt_bp(precision="fp32"), _port_opts(
        root, "VOICE2POSE.GENERATOR.CLIP_CODE.FRAME_VARIANT", "True"))
    port = Voice2PoseTrainState(cfg, 8, "cpu")
    assert tuple(port.clips_code.shape) == (8, 32, 64) and port.opt_code is not None
    port.load(state_from_jax(jax.device_get(pipe.state)))
    return dict(port=port, bank=bank, **_two_steps(pipe, port))


@pytest.mark.parametrize("step", range(STEPS))
def test_frame_variant_kl_matches_jax(frame_run, step):
    """The KL over the (B*T, 32) rows of the batch's (B, 32, 64) codes: rtol
    1e-5 at step 1 (the same bank), 1e-3 at step 2, after each side's Adam
    step moved the bank by ~lr * sign(grad)."""
    jl, tl = frame_run["jax"][step], frame_run["ported"][step]
    assert jl["G_clipcode_kl_loss"] > 0
    np.testing.assert_allclose(tl["G_clipcode_kl_loss"], jl["G_clipcode_kl_loss"],
                               rtol=(1e-5, 1e-3)[step])
    np.testing.assert_allclose(tl["G_reg_loss"], jl["G_reg_loss"], rtol=(1e-4, 1e-3)[step])


def test_frame_variant_bank_moves_like_jax(frame_run):
    """After two Adam steps each bank entry moved by up to 2 lr, the same way
    on both sides but where a gradient near zero flips in fp32."""
    got = frame_run["port"].clips_code.detach().numpy()
    want, bank, lr = frame_run["jax_bank"], frame_run["bank"], 1e-4
    assert got.shape == want.shape == (8, 32, 64)
    moved = np.abs(want - bank)
    assert moved.max() <= 2 * lr * 1.001 and (moved > 0.5 * lr).mean() > 0.5
    assert (np.abs(got - want) > 0.1 * lr).mean() <= 1e-2


def test_external_code_needs_a_checkpoint(speaker):
    root, ckpt, bank = speaker
    cfg = apply_overrides(sdt_vae(precision="fp32"), _port_opts(root))
    with pytest.raises(ValueError, match="EXTERNAL_CODE needs a Pose2Pose checkpoint"):
        Voice2PoseTrainState(cfg, 8, "cpu")
    cfg = apply_overrides(sdt_vae(precision="fp32"), _port_opts(
        root, "VOICE2POSE.GENERATOR.CLIP_CODE.EXTERNAL_CODE_PTH", ckpt,
        "VOICE2POSE.POSE_ENCODER.NAME", "None"))
    state = Voice2PoseTrainState(cfg, 8, "cpu")
    torch.testing.assert_close(state.clips_code, bank, rtol=0, atol=0)
    with pytest.raises(ValueError, match="8 rows but the train split has 12"):
        Voice2PoseTrainState(cfg, 12, "cpu")
