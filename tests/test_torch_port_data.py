"""The port's train data path against the JAX package's, on the CPU: the
synthetic speaker writer, the dataset's items, the loader's batch schedule,
the pose transforms and step metrics, the audio length helpers and the
config overrides; and the options the port refuses, with their roadmap item."""

import os

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=6, num_dev=2, seed=3)
    return root


def _jax_dataset(root):
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JDS

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.DATASET.ROOT_DIR = root
    cfg.DATASET.SPEAKER = "oliver"
    cfg.freeze()
    return JDS(root, "oliver", "train", cfg)


def _port_cfg(root, *opts):
    # loaders read in-process here: no worker processes forked from a process
    # that holds JAX's threads
    return apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0",
                                      *opts])


def test_synthetic_writer_matches_jax(tmp_path):
    from speechdrivestemplates_tpu.datasets.synthetic import \
        make_synthetic_speaker as jax_make

    a = make_synthetic_speaker(str(tmp_path / "port"), "oliver", num_train=3, num_dev=2,
                               seed=5)
    b = jax_make(str(tmp_path / "jax"), "oliver", num_train=3, num_dev=2, seed=5)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, "processed_137.csv"), "rb") as fa, \
            open(os.path.join(b, "processed_137.csv"), "rb") as fb:
        assert fa.read() == fb.read()
    for name in sorted(os.listdir(a)):
        if name.endswith(".npz"):
            with np.load(os.path.join(a, name)) as za, np.load(os.path.join(b, name)) as zb:
                assert za.files == zb.files
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    np.testing.assert_array_equal(za[k], zb[k])


def test_dataset_items_match_jax(speaker_root):
    """The JAX side may read through its native loader, whose float order
    differs from numpy's: poses at rtol/atol 1e-5, the rest exact."""
    ds = GestureDataset(speaker_root, "oliver", _port_cfg(speaker_root))
    jds = _jax_dataset(speaker_root)
    assert len(ds) == len(jds) == 6
    for i in range(len(ds)):
        got, ref = ds[i], jds[i]
        assert got["audio"].dtype == np.float32 and got["audio"].shape == (68266,)
        np.testing.assert_array_equal(got["audio"], ref["audio"])
        assert got["poses"].dtype == np.float32 and got["poses"].shape == (64, 2, 121)
        np.testing.assert_allclose(got["poses"], ref["poses"], rtol=1e-5, atol=1e-5)
        assert int(got["clip_index"]) == int(ref["clip_index"]) == i
        for k in ("mean", "std", "scale_factor"):
            np.testing.assert_array_equal(got["speaker_stat"][k], ref["speaker_stat"][k])


def test_dataset_subset_and_joined_speakers(tmp_path):
    root = str(tmp_path / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=3, num_dev=1, seed=0)
    make_synthetic_speaker(root, "kubinec", num_train=2, num_dev=1, seed=1)
    ds = GestureDataset(root, "oliver+kubinec", _port_cfg(root))
    assert len(ds) == 5 and {c["speaker"] for c in ds.clips} == {"oliver", "kubinec"}
    sub = GestureDataset(root, "oliver", _port_cfg(root, "DATASET.SUBSET", "2"))
    assert len(sub) == 2


@pytest.mark.parametrize("seed", [0, 7])
def test_batch_schedule_matches_jax(speaker_root, seed):
    """RandomState(seed + epoch) shuffles, full batches only: the same index
    batches as the JAX loader, epoch by epoch."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import DataLoader as JDL

    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    loader = train_loader(_port_cfg(speaker_root, "TRAIN.BATCH_SIZE", "4",
                                    "SYS.SEED", str(seed)))
    jloader = JDL(_jax_dataset(speaker_root), batch_size=4, shuffle=True,
                  drop_last=True, seed=seed)
    for epoch in (1, 2):
        loader.batch_sampler.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, ref = loader.batch_sampler.index_batches(), jloader.index_batches()
        assert len(got) == len(ref) == len(loader) == 1
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        batches = list(loader)
        assert len(batches) == 1
        b = batches[0]
        np.testing.assert_array_equal(b["clip_index"].numpy(), ref[0])
        assert b["audio"].shape == (4, 68266) and b["poses"].shape == (4, 64, 2, 121)
        assert b["speaker_stat"]["mean"].shape == (4, 242)
        assert b["speaker_stat"]["scale_factor"].shape == (4,)


_WORKER_LOADER = """
import sys
import numpy as np
from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader
root = sys.argv[1]
loader = train_loader(apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", root, "TRAIN.BATCH_SIZE",
                                                 "1", "SYS.NUM_WORKERS", "2"]))
ds = loader.dataset
for epoch in (1, 2):
    loader.batch_sampler.set_epoch(epoch)
    want = [b.tolist() for b in loader.batch_sampler.index_batches()]
    it = iter(loader)
    assert next(it)["clip_index"].tolist() == want[0]
    del it  # a consumer that stops early
    batches = list(loader)
    assert [b["clip_index"].tolist() for b in batches] == want, epoch
    np.testing.assert_array_equal(batches[-1]["poses"][0].numpy(), ds[want[-1][0]]["poses"])
print("ok")
"""


def test_loader_stops_early_without_hanging(speaker_root):
    """Two worker processes that outlive each epoch (run in a process of its
    own, which holds no JAX threads to fork): a consumer may stop after one
    batch; each epoch then yields the schedule's batches in order, with the
    dataset's items."""
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    r = subprocess.run([sys.executable, "-c", _WORKER_LOADER, speaker_root], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_pose_transforms_match_jax(rng):
    from speechdrivestemplates_tpu.ops import pose as jpose
    from speechdrivestemplates_tpu_torch.ops import pose as tpose

    raw = (rng.rand(5, 3, 137) * 600).astype(np.float32)
    k122 = tpose.remove_unused_kp(raw)
    np.testing.assert_array_equal(k122, jpose.remove_unused_kp(raw))
    np.testing.assert_array_equal(tpose.absolute_to_relative(k122),
                                  jpose.absolute_to_relative(k122))
    rel = tpose.absolute_to_relative(k122)
    np.testing.assert_array_equal(tpose.global_to_parted(rel), jpose.global_to_parted(rel))
    np.testing.assert_array_equal(tpose.global_to_parted(rel[:, :2]),
                                  jpose.global_to_parted(rel[:, :2]))
    mean = rng.randn(242).astype(np.float32)
    std = (rng.rand(242) + 0.5).astype(np.float32)
    np.testing.assert_array_equal(tpose.normalize_poses(rel[:, :2], mean, std),
                                  jpose.normalize_poses(rel[:, :2], mean, std))
    # parted -> global undoes global -> parted
    back = tpose.parted_to_global(torch.from_numpy(tpose.global_to_parted(rel[:, :2])))
    np.testing.assert_allclose(back.numpy(), rel[:, :2], rtol=1e-6, atol=1e-3)


def test_step_metrics_match_jax(rng):
    import jax.numpy as jnp

    from speechdrivestemplates_tpu.pipelines.voice2pose import Voice2Pose
    from speechdrivestemplates_tpu_torch.ops.pose import step_metrics

    pred = (rng.randn(3, 8, 2, 121) * 50).astype(np.float32)
    gt = (rng.randn(3, 8, 2, 121) * 50).astype(np.float32)
    ref = Voice2Pose._step_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = step_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(got) == set(ref) == {"L2_dist", "lip_sync_error_n"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)


def test_audio_helpers_match_jax(rng):
    from speechdrivestemplates_tpu.utils import audio as jaudio
    from speechdrivestemplates_tpu_torch.utils import audio as taudio

    for n, sr, fps in ((68267, 16000, 15), (16000, 16000, 15), (100000, 22050, 25)):
        assert taudio.parse_audio_length(n, sr, fps) == jaudio.parse_audio_length(n, sr, fps)
    wav = rng.randn(1000).astype(np.float32)
    for length in (500, 1000, 1500):
        got = taudio.crop_pad_audio(wav, length)
        np.testing.assert_array_equal(got, jaudio.crop_pad_audio(wav, length))
        assert got.dtype == np.float32


def test_overrides_parse_like_yacs():
    """The port's overrides against yacs' merge_from_list on the keys the
    train path reads: values take the type of the key's current value."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    opts = ["TRAIN.NUM_EPOCHS", "3", "TRAIN.LR", "1e-3", "TRAIN.VALIDATE", "False",
            "TRAIN.BATCH_SIZE", "2", "DATASET.ROOT_DIR", "/data/speakers",
            "DATASET.SUBSET", "10", "SYS.SEED", "4", "SYS.OUTPUT_DIR", "out/runs",
            "SYS.NUM_WORKERS", "2",
            "VOICE2POSE.GENERATOR.LAMBDA_CLIP_KL", "1", "POSE2POSE.AUTOENCODER.CODE_DIM", "16",
            "TRAIN.PRECISION", "fp32", "VOICE2POSE.GENERATOR.CLIP_CODE.LR_SCALING", "10"]
    cfg = apply_overrides(sdt_bp(), list(opts))
    ref = get_cfg_defaults()
    ref.merge_from_list(list(opts))
    for key in opts[0::2]:
        got, want = cfg, ref
        for part in key.split("."):
            got, want = getattr(got, part), want[part]
        assert got == want and type(got) is type(want), (key, got, want)
    with pytest.raises(KeyError, match="Non-existent"):
        apply_overrides(sdt_bp(), ["TRAIN.NOPE", "1"])
    with pytest.raises(KeyError, match="Non-existent"):
        apply_overrides(sdt_bp(), ["TRAIN", "1"])
    with pytest.raises(ValueError, match="Type mismatch"):
        apply_overrides(sdt_bp(), ["TRAIN.NUM_EPOCHS", "1.5"])
    with pytest.raises(ValueError, match="pairs"):
        apply_overrides(sdt_bp(), ["TRAIN.NUM_EPOCHS"])


@pytest.mark.parametrize("opts,match", [
    (["SYS.WORLD_SIZE", "0"], "SYS.WORLD_SIZE 0"),
    (["TRAIN.VALIDATE", "True", "SYS.MESH.DATA", "2"], "SYS.MESH.DATA 2 with SYS.WORLD_SIZE 1"),
    (["PIPELINE_TYPE", "Pose2Pose", "POSE2POSE.AUTOENCODER.NAME", "Autoencoder",
      "SYS.WORLD_SIZE", "2", "SYS.MESH.DATA", "4"], "SYS.MESH.DATA 4 with SYS.WORLD_SIZE 2"),
])
def test_unported_options_raise_naming_the_roadmap(speaker_root, tmp_path, opts, match):
    """What the port refuses is refused before anything is written. Since the
    parallel keys (item 14) are ported, no option names the roadmap any
    more: what is left are parallel keys that map onto no ranks (a world of
    no rank, a SYS.MESH.DATA that is not the rank count)."""
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train

    base = ["TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False",
            "SYS.OUTPUT_DIR", str(tmp_path)]
    cfg = _port_cfg(speaker_root, *base, *opts)
    with pytest.raises(ValueError, match=match):
        train(cfg, "t", device="cpu")
    assert not os.listdir(tmp_path)  # refused before anything is written


@pytest.mark.parametrize("opt", ["discriminator", "code_less", "global_poses"])
def test_s2g_options_train_on_sdt_bp(speaker_root, tmp_path, opt):
    """Each of s2g's options, which the port refused before it ported s2g,
    alone on SDT-BP: one epoch of one step trains and writes a checkpoint
    that shows it (the discriminator's losses and ``netD_pose.*``; no bank
    and no KL; global poses and their statistics)."""
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train
    from speechdrivestemplates_tpu_torch.utils.weights import read_pth

    opts = {"discriminator": ["VOICE2POSE.POSE_DISCRIMINATOR.NAME", "PoseSequenceDiscriminator"],
            "code_less": ["VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION", "None"],
            "global_poses": ["DATASET.HIERARCHICAL_POSE", "False"]}[opt]
    cfg = _port_cfg(speaker_root, "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False",
                    "SYS.OUTPUT_DIR", str(tmp_path), "TRAIN.PRECISION", "fp32",
                    "TRAIN.BATCH_SIZE", "2", "DATASET.SUBSET", "2", "TRAIN.NUM_EPOCHS", "1",
                    *opts)
    out = train(cfg, "t", device="cpu")
    sd = read_pth(out["checkpoint"])
    assert out["steps"] == 1 and all(np.isfinite(v) for v in out["losses"].values())
    assert ("D_pose_gan_loss" in out["losses"]) == (opt == "discriminator")
    assert any(k.startswith("netD_pose.") for k in sd) == (opt == "discriminator")
    has_code = opt != "code_less"
    assert ("G_clipcode_kl_loss" in out["losses"]) == ("clips_code" in sd) == has_code
    if opt == "global_poses":
        item = GestureDataset(speaker_root, "oliver", cfg)[0]
        np.testing.assert_array_equal(item["speaker_stat"]["mean"],
                                      item["speaker_stat_global"]["mean"])


def test_train_step_without_a_pose_encoder(speaker_root):
    """VOICE2POSE.POSE_ENCODER.NAME None (as in the JAX pipeline): no FGD
    features, no pose-encoder keys in the checkpoint; the rest of the step runs."""
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                     train_step)

    cfg = _port_cfg(speaker_root, "TRAIN.BATCH_SIZE", "2", "TRAIN.PRECISION", "fp32",
                    "VOICE2POSE.POSE_ENCODER.NAME", "None")
    loader = train_loader(cfg)
    state = Voice2PoseTrainState(cfg, len(loader.dataset), "cpu")
    assert state.pose_encoder is None
    losses, results = train_step(state, next(iter(loader)))
    assert "mu_pred" not in results and results["poses_pred_batch"].shape == (2, 64, 2, 121)
    assert all(torch.isfinite(v) for v in losses.values())
    keys = set(state.state_dict())
    assert "clips_code" in keys and not any(k.startswith("pose_encoder.") for k in keys)
