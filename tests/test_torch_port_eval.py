"""The port's test-only path (``trainer.test``, ``voice2pose.eval_step``, FGD)
against the JAX package's ``--test_only``, on the CPU.

A synthetic speaker with 8 train and 97 dev clips (TEST.BATCH_SIZE 2, so the
last batch holds one clip; 97 latents keep the 64-wide FGD covariances of
full rank). The port trains two Pose2Pose steps and writes its ``.pth``; with it
as VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT, two SDT-BP steps drift the frozen
encoder's statistics and write the SDT-BP ``.pth``. Both packages then test
that checkpoint, fp32, the codes fixed by CLIP_CODE.TEST_WITH_GT_CODE (the
default draws bank rows at random, which the port cannot reproduce) or
injected on both sides.
"""

import os

import jax
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, sdt_bp
from speechdrivestemplates_tpu_torch.ops.fgd import compute_fgd
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                 eval_step, train_step)
from speechdrivestemplates_tpu_torch.utils.weights import read_pth

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
NUM_DEV = 97
METRICS = ("G_reg_loss", "L2_dist", "lip_sync_error_n")


def _opts(root, out, *extra):
    return ["DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", out, "SYS.NUM_WORKERS", "0",
            "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "2", "TRAIN.PRECISION", "fp32",
            "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False", "TEST.SAVE_NPZ", "False",
            "TRAIN.VALIDATE", "False", "SYS.LOG_INTERVAL", "1000", *extra]


def _jax_test_cfg(root, out, ae_ckpt):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.merge_from_list(["DATASET.ROOT_DIR", root, "DATASET.SPEAKER", "oliver",
                         "SYS.OUTPUT_DIR", out, "SYS.MESH.DATA", "1", "TEST.BATCH_SIZE", "2",
                         "TEST.SAVE_VIDEO", "False", "TEST.SAVE_NPZ", "False",
                         "VOICE2POSE.GENERATOR.CLIP_CODE.TEST_WITH_GT_CODE", "True",
                         "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_ckpt])
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu_torch.pipelines import pose2pose as p2p

    tmp = tmp_path_factory.mktemp("eval")
    root, out = str(tmp / "speakers"), str(tmp / "out")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=NUM_DEV, seed=4)

    pcfg = apply_overrides(pose2pose(), _opts(root, out))
    loader = trainer.train_loader(pcfg)
    ae_state = p2p.Pose2PoseTrainState(pcfg, len(loader.dataset), "cpu")
    loader.batch_sampler.set_epoch(1)
    for b in loader:
        p2p.train_step(ae_state, b)  # two steps
    ae_ckpt = str(tmp / "ae.pth")
    ae_state.save_checkpoint(ae_ckpt, 1, 2)

    bcfg = apply_overrides(sdt_bp(), _opts(root, out, "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT",
                                           ae_ckpt))
    state = Voice2PoseTrainState(bcfg, len(loader.dataset), "cpu")
    for b in loader:
        train_step(state, b)
    bp_ckpt = str(tmp / "bp.pth")
    state.save_checkpoint(bp_ckpt, 1, 2)

    tcfg = apply_overrides(sdt_bp(), _opts(
        root, out, "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_ckpt,
        "VOICE2POSE.GENERATOR.CLIP_CODE.TEST_WITH_GT_CODE", "True"))
    port = trainer.test(tcfg, bp_ckpt, "t", "cpu")
    jcfg = _jax_test_cfg(root, out, ae_ckpt)
    pipe = get_pipeline("Voice2Pose")(jcfg)
    jax_metrics = {k: float(v) for k, v in pipe.test(jcfg, "t", bp_ckpt).items()}
    return dict(root=root, out=out, ae_ckpt=ae_ckpt, bp_ckpt=bp_ckpt, tcfg=tcfg, pipe=pipe,
                port=port, jax=jax_metrics)


@pytest.mark.parametrize("key", METRICS)
def test_test_only_metrics_match_jax(run, key):
    """Epoch means over 97 clips in 49 batches, the last of one clip: rtol 1e-4."""
    assert run["port"]["num_samples"] == NUM_DEV
    np.testing.assert_allclose(run["port"]["metrics"][key], run["jax"][key], rtol=1e-4)


@pytest.mark.parametrize("key", ["FGD_mu", "FGD_mu_logvar"])
def test_test_only_fgd_matches_jax(run, key):
    got, want = run["port"]["metrics"][key], run["jax"][key]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_ragged_last_batch_counts_as_one_clip(run):
    """The clip-code KL of a one-clip batch is NaN on both sides (an unbiased
    variance of one sample), so the epoch mean is too; every other metric is
    the mean over 97 clips, not over 49 x 2."""
    assert np.isnan(run["port"]["metrics"]["G_clipcode_kl_loss"])
    assert np.isnan(run["jax"]["G_clipcode_kl_loss"])
    assert set(run["port"]["metrics"]) == set(run["jax"])


def test_injected_codes_match_jax(run):
    """The eval step with the same random codes on both sides (JAX's
    ``fixed_code``), batch by batch: the losses at rtol 1e-4, and the FGD of
    the collected latents at rtol 1e-3."""
    from speechdrivestemplates_tpu.ops.mel import mel_frames_for_audio_length

    pipe, rng = run["pipe"], np.random.RandomState(0)
    state = Voice2PoseTrainState(run["tcfg"], None, "cpu")
    state.load_pth(run["bp_ckpt"])
    lat = {"jax": {}, "port": {}}
    for jb, tb in zip(pipe.test_dataloader, trainer.eval_loader(run["tcfg"])):
        np.testing.assert_array_equal(np.asarray(jb["poses"]), tb["poses"].numpy())
        code = rng.randn(tb["poses"].shape[0], 32).astype(np.float32)
        db, valid, sig = pipe._device_eval_batch(jb)
        step = pipe._get_eval_step(64, mel_frames_for_audio_length(jb["audio"].shape[-1]),
                                   valid, sig)
        jl, jr = step(pipe.state, db, jax.random.PRNGKey(0), None, code)
        tl, tr = eval_step(state, tb, fixed_code=torch.from_numpy(code))
        for k in METRICS:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, err_msg=k)
        for k in ("mu_pred", "logvar_pred", "mu_gt", "logvar_gt"):
            lat["jax"].setdefault(k, []).append(np.asarray(jr[k]))
            lat["port"].setdefault(k, []).append(tr[k].numpy())
    fgd = {side: compute_fgd(np.concatenate(v["mu_pred"]), np.concatenate(v["mu_gt"]))
           for side, v in lat.items()}
    np.testing.assert_allclose(fgd["port"], fgd["jax"], rtol=1e-3)


def test_checkpoint_encoder_wins_over_the_ae_checkpoint(run):
    """With AE_CHECKPOINT set, the frozen encoder starts from the Pose2Pose
    checkpoint's ``ae.encoder.*``; the tested checkpoint's ``pose_encoder.*``
    (running statistics drifted by two train steps) then replace them, in the
    port as in the JAX package."""
    ae = read_pth(run["ae_ckpt"])
    bp = read_pth(run["bp_ckpt"])
    state = Voice2PoseTrainState(run["tcfg"], None, "cpu")
    key = "blocks.3.norm.running_var"
    torch.testing.assert_close(state.pose_encoder.state_dict()[key], ae[f"ae.encoder.{key}"])
    assert not torch.equal(ae[f"ae.encoder.{key}"], bp[f"pose_encoder.{key}"])
    # two Pose2Pose steps, then two SDT-BP steps of two encoder forwards each
    assert int(bp["pose_encoder.blocks.0.norm.num_batches_tracked"]) == 2 + 2 * 2
    state.load_pth(run["bp_ckpt"])
    for k, v in state.pose_encoder.state_dict().items():
        torch.testing.assert_close(v, bp[f"pose_encoder.{k}"], rtol=0, atol=0)
    jstats = jax.device_get(run["pipe"].state["batch_stats_pe"])
    np.testing.assert_array_equal(jstats["ConvNormRelu_3"]["norm"]["var"],
                                  bp[f"pose_encoder.{key}"].numpy())


def test_compute_fgd_matches_jax(rng):
    from speechdrivestemplates_tpu.ops.fgd import compute_fgd as jax_fgd

    for n, d, shift in ((200, 32, 0.3), (97, 64, 1.0), (40, 8, 0.0)):
        a = rng.randn(n, d) * rng.uniform(0.5, 2.0, d)
        b = rng.randn(n + 3, d) + shift
        got, want = compute_fgd(a, b), jax_fgd(a, b)
        assert abs(got - want) <= 1e-10 * max(1.0, abs(want)), (n, d, got, want)
    assert compute_fgd(a, a) == pytest.approx(0.0, abs=1e-9)


def test_bank_and_encoder_checkpoints_are_checked(run, tmp_path):
    """A Pose2Pose bank of the wrong row count, and an AE checkpoint that does
    not fill the encoder, are refused."""
    from speechdrivestemplates_tpu_torch.utils.weights import external_code_bank

    with pytest.raises(ValueError, match="8 rows but the train split has 9"):
        external_code_bank(run["ae_ckpt"], 9)
    assert external_code_bank(run["ae_ckpt"], 8).shape == (8, 32)
    sd = read_pth(run["ae_ckpt"])
    del sd["ae.encoder.blocks.6.norm.running_var"]
    bad = str(tmp_path / "bad.pth")
    torch.save({"model_state_dict": sd}, bad)
    cfg = apply_overrides(sdt_bp(precision="fp32"),
                          ["VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", bad])
    with pytest.raises(ValueError, match="does not fill the frozen encoder"):
        Voice2PoseTrainState(cfg, 8, "cpu")


def test_eval_code_modes(run):
    """``condition_code``'s eval modes, which the JAX draws cannot pin: a bank
    row per sample drawn from the state's seeded generator (the default),
    N(0, 1) codes (SAMPLE_FROM_NORMAL), a fixed row (DEMO.CODE_INDEX) moved
    towards another (CODE_INDEX_B); each by shape, range and reproducibility
    from SYS.SEED."""
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import condition_code

    def state(*opts):
        cfg = apply_overrides(sdt_bp(precision="fp32"), _opts(run["root"], run["out"], *opts))
        s = Voice2PoseTrainState(cfg, None, "cpu")
        s.load_pth(run["bp_ckpt"])
        return s

    batch = {"audio": torch.zeros(64, 10)}
    a, b = state(), state()
    bank = a.clips_code.detach()
    codes = condition_code(a, batch)
    assert codes.shape == (64, 32)
    rows = [int((bank == c).all(1).nonzero()[0]) for c in codes]  # each code is a bank row
    assert len(set(rows)) > 4
    torch.testing.assert_close(condition_code(b, batch), codes, rtol=0, atol=0)
    assert not torch.equal(condition_code(a, batch), codes)  # the stream moves on

    n1, n2 = state("VOICE2POSE.GENERATOR.CLIP_CODE.SAMPLE_FROM_NORMAL", "True"), \
        state("VOICE2POSE.GENERATOR.CLIP_CODE.SAMPLE_FROM_NORMAL", "True", "SYS.SEED", "1")
    z = condition_code(n1, batch)
    assert z.shape == (64, 32) and abs(float(z.mean())) < 0.1 and 0.9 < float(z.std()) < 1.1
    assert not torch.equal(z, condition_code(n2, batch))

    d = state("DEMO.CODE_INDEX", "3", "DEMO.CODE_INDEX_B", "5")
    torch.testing.assert_close(condition_code(d, batch), bank[3].expand(64, 32))
    torch.testing.assert_close(condition_code(d, batch, interpolation_coeff=0.25),
                               (0.75 * bank[3] + 0.25 * bank[5]).expand(64, 32))
