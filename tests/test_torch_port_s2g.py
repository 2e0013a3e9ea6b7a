"""The s2g-GAN modules of the port against the JAX package's, and s2g through
the port's trainer options, on the CPU.

BN on a 2-D ConvNormRelu and the ``PoseSequenceDiscriminator`` against their
JAX modules (train and eval, fp32); global poses: the parted -> global
re-normalization, the dataset item and the SoA cache against the JAX dataset;
then s2g through ``--resume_from`` and K = 3 steps a chunk, bit for bit
against straight runs.
"""

import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, s2g
from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.models.blocks import ConvNormRelu
from speechdrivestemplates_tpu_torch.pipelines import checkpoint as C
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import disc_input
from speechdrivestemplates_tpu_torch.utils.weights import read_pth

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
WHITE_LIST = list(range(0, 121, 3))  # 41 keypoints


def _jax_cfg(*opts):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_s2g.yaml"))
    cfg.merge_from_list(["DATASET.SPEAKER", "oliver", *opts])
    return cfg


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s2g") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=2, seed=5)
    return root


def _bn_tree(rng, c):
    """Non-trivial BN parameters and running statistics for ``c`` channels."""
    return ({"scale": (1 + 0.3 * rng.randn(c)).astype(np.float32),
             "bias": (0.2 * rng.randn(c)).astype(np.float32)},
            {"mean": (0.3 * rng.randn(c)).astype(np.float32),
             "var": (0.5 + rng.rand(c)).astype(np.float32)})


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("spec", [{}, {"downsample": True},
                                  {"kernel_size": (6, 3), "stride": 1, "padding": 0}],
                         ids=["k3", "k4s2", "k6x3"])
def test_bn_conv_norm_relu_2d_matches_jax(spec, train):
    """The generator's BN layer, ``ConvNormRelu('2d', norm='BN')``, against
    JAX's on a (3, 5, 12, 10) input, fp32: the output and, in train mode, the
    running statistics after the forward (torch's unbiased n/(n-1) variance
    EMA over n = B*H*W), rtol 1e-5."""
    from speechdrivestemplates_tpu.models.blocks import ConvNormRelu as JaxCNR

    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 12, 10).astype(np.float32)
    jm = JaxCNR(conv_type="2d", out_channels=6, norm="BN", leaky=True, **spec)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), xj, True))
    norm, stats = _bn_tree(rng, 6)
    params = {"conv": variables["params"]["conv"], "norm": norm}
    out = jm.apply({"params": params, "batch_stats": {"norm": stats}}, xj, train,
                   mutable=["batch_stats"])
    want, new_stats = np.asarray(out[0]).transpose(0, 3, 1, 2), out[1]["batch_stats"]["norm"]

    m = ConvNormRelu("2d", 5, 6, norm="BN", leaky=True, **spec).train(train)
    m.load_state_dict({
        "conv.weight": torch.tensor(np.transpose(params["conv"]["kernel"], (3, 2, 0, 1))),
        "norm.weight": torch.from_numpy(norm["scale"]),
        "norm.bias": torch.from_numpy(norm["bias"]),
        "norm.running_mean": torch.from_numpy(stats["mean"]),
        "norm.running_var": torch.from_numpy(stats["var"]),
        "norm.num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.norm.running_mean.numpy(), np.asarray(new_stats["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(m.norm.running_var.numpy(), np.asarray(new_stats["var"]),
                               rtol=1e-5)
    assert int(m.norm.num_batches_tracked) == int(train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_matches_jax(train):
    """``PoseSequenceDiscriminator`` at full width (leaky, as s2g's preset),
    fed by ``disc_input`` with MOTION and a WHITE_LIST of 41 keypoints (parsed
    from the command line as yacs does): the input equals JAX ``_disc_input``'s,
    the (3, 15) scores and, in train mode, the three BN layers' running
    statistics match JAX's at rtol 1e-5."""
    from speechdrivestemplates_tpu.models.discriminator import PoseSequenceDiscriminator
    from speechdrivestemplates_tpu.pipelines.voice2pose import Voice2Pose
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.utils.weights import discriminator_params_from_jax

    wl = ["VOICE2POSE.POSE_DISCRIMINATOR.WHITE_LIST", str(WHITE_LIST)]
    cfg = apply_overrides(s2g(precision="fp32"), list(wl))
    assert cfg.VOICE2POSE.POSE_DISCRIMINATOR.WHITE_LIST == WHITE_LIST
    jcfg = _jax_cfg(*wl)
    rng = np.random.RandomState(4)
    poses = rng.randn(3, 64, 2, 121).astype(np.float32)
    jin = np.asarray(Voice2Pose._disc_input(SimpleNamespace(cfg=jcfg), jnp.asarray(poses)))
    tin = disc_input(torch.from_numpy(poses), cfg)
    assert tin.shape == jin.shape == (3, 63, 2, len(WHITE_LIST))
    np.testing.assert_array_equal(tin.numpy(), jin)

    jm = PoseSequenceDiscriminator(leaky=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 63, 2, len(WHITE_LIST))),
                               True))
    params, stats = dict(v["params"]), {}
    for i in range(3):
        norm, st = _bn_tree(rng, params[f"ConvNormRelu_{i}"]["norm"]["scale"].shape[0])
        params[f"ConvNormRelu_{i}"] = dict(params[f"ConvNormRelu_{i}"], norm=norm)
        stats[f"ConvNormRelu_{i}"] = {"norm": st}
    out, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(jin), train,
                        mutable=["batch_stats"])
    d = build_model("PoseSequenceDiscriminator", cfg, "cpu").train(train)
    d.load_state_dict(discriminator_params_from_jax(params, stats))
    with torch.no_grad():
        got = d(tin).numpy()
    assert got.shape == (3, 15)
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-5, atol=1e-6)
    for i in range(3):
        want = upd["batch_stats"][f"ConvNormRelu_{i}"]["norm"]
        np.testing.assert_allclose(d.seq[i].norm.running_mean.numpy(),
                                   np.asarray(want["mean"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(d.seq[i].norm.running_var.numpy(), np.asarray(want["var"]),
                                   rtol=1e-5)


def test_discriminator_output_layer_init_follows_flax():
    """The output Conv1d (1024 -> 1, k3) starts as flax ``nn.Conv`` does:
    LeCun normal over fan_in = 3 * 1024, truncated at 2 sigma, zero bias."""
    from speechdrivestemplates_tpu_torch.models import build_model

    out = build_model("PoseSequenceDiscriminator", s2g(), "cpu").seq[3]
    w = out.weight.detach().double()
    assert tuple(w.shape) == (1, 1024, 3) and not out.bias.detach().any()
    std = (1.0 / 3072) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(w.std().item() - std) < 0.1 * std


def test_parted_to_global_renormalization_matches_jax():
    """``transform_normalized_parted2global`` on (3, 8, 2, 121) poses with the
    speaker's parted and global statistics: bit for bit JAX's."""
    from speechdrivestemplates_tpu.ops.pose import (
        transform_normalized_parted2global as jax_p2g)
    from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat
    from speechdrivestemplates_tpu_torch.ops.pose import transform_normalized_parted2global

    rng = np.random.RandomState(5)
    poses = rng.randn(3, 8, 2, 121).astype(np.float32)
    p, g = (get_speaker_stat("oliver", 121, parted) for parted in (True, False))
    stats = [np.repeat(s[k][None], 3, 0) for s in (p, g) for k in ("mean", "std")]
    want = np.asarray(jax_p2g(jnp.asarray(poses), *map(jnp.asarray, stats)))
    got = transform_normalized_parted2global(torch.from_numpy(poses),
                                             *map(torch.from_numpy, stats)).numpy()
    np.testing.assert_array_equal(got, want)


def _np_tree(batch):
    return {k: ({kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in batch.items()}


def test_global_pose_items_equal_the_jax_dataset(speaker_root):
    """HIERARCHICAL_POSE False: each train item's audio, global poses z-scored
    with the global statistics, ``speaker_stat`` (the global table) and
    ``speaker_stat_global`` equal the JAX dataset's, exactly."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JaxDataset

    jds = JaxDataset(speaker_root, "oliver", "train", _jax_cfg())
    ds = GestureDataset(speaker_root, "oliver", s2g())
    assert len(ds) == len(jds) == 8
    for i in range(len(ds)):
        item, jitem = ds[i], jds[i]
        for k in ("audio", "poses"):
            np.testing.assert_array_equal(item[k], jitem[k], err_msg=k)
        for key in ("speaker_stat", "speaker_stat_global"):
            for k, v in item[key].items():
                np.testing.assert_array_equal(v, jitem[key][k], err_msg=f"{key}.{k}")
    np.testing.assert_array_equal(ds[0]["speaker_stat"]["mean"],
                                  ds[0]["speaker_stat_global"]["mean"])


def test_global_pose_soa_cache_equals_jax_materialize(speaker_root):
    """DATASET.CACHING: the SoA arrays (``speaker_stat_global`` nested as
    ``speaker_stat`` is) equal the JAX ``materialize()`` and the per-item
    collate; a gather equals the collate of its items; the device cache
    stages ``speaker_stat_global``."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JaxDataset
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import DEVICE_KEYS

    jcfg = _jax_cfg("DATASET.CACHING", "True")
    jsoa = JaxDataset(speaker_root, "oliver", "train", jcfg).materialize()
    cfg = apply_overrides(s2g(), ["DATASET.CACHING", "True"])
    ds = GestureDataset(speaker_root, "oliver", cfg)
    soa = ds.materialize()
    for k in ("audio", "poses"):
        np.testing.assert_array_equal(soa[k], jsoa[k], err_msg=k)
    for key in ("speaker_stat", "speaker_stat_global"):
        for k in soa[key]:
            np.testing.assert_array_equal(soa[key][k], jsoa[key][k], err_msg=f"{key}.{k}")
    plain = GestureDataset(speaker_root, "oliver", s2g())
    for idx in (list(range(8)), [5, 2, 2]):
        want = _np_tree(collate([plain[i] for i in idx]))
        got = ds.gather(idx)
        assert set(got) == set(want)
        for k, v in want.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
                g = got[k][kk] if kk else got[k]
                np.testing.assert_array_equal(g, vv, err_msg=f"{k}.{kk}")
    staged = apply_overrides(s2g(), [
        "DATASET.ROOT_DIR", speaker_root, "DATASET.CACHING", "True", "DATASET.DEVICE_CACHE",
        "on", "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "2"])
    cache, line = trainer.stage_device_cache(staged, trainer.train_loader(staged), "cpu",
                                             DEVICE_KEYS)
    assert cache is not None and set(cache) == set(DEVICE_KEYS), line
    assert set(cache["speaker_stat_global"]) == {"mean", "std", "scale_factor"}


def test_code_less_generator_takes_no_code():
    """s2g's generator: no bank, a UNet whose input is the encoder's 256
    channels, ``forward(mel, T, None)``."""
    from speechdrivestemplates_tpu_torch.models import build_model

    gen = build_model("SequenceGeneratorCNN", s2g(precision="fp32"), "cpu")
    assert gen.code_dim is None and gen.unet.e0.conv.weight.shape[1] == 256
    with torch.no_grad():
        out = gen(torch.randn(2, 80, 214), 32, None)
    assert out.shape == (2, 32, 2, 121) and torch.isfinite(out).all()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU steps run fastest on one intra-op thread, and the suite runs
    several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(root, out, *extra):
    return apply_overrides(s2g(precision="fp32"), [
        "DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", str(out), "TRAIN.BATCH_SIZE", "2",
        "TRAIN.SAVE_VIDEO", "False", "TRAIN.VALIDATE", "False", "SYS.NUM_WORKERS", "0",
        *extra])


def test_s2g_resume_continues_the_run_bit_for_bit(speaker_root, tmp_path):
    """3 epochs straight (2 clips, one step an epoch) against the same run
    resumed from its epoch-1 checkpoint: the last .pth (``netD_pose.*``
    included) and its resume file (the generator's and D's Adams and
    schedulers, D last) agree bit for bit."""
    extra = ["TRAIN.NUM_EPOCHS", "3", "DATASET.SUBSET", "2"]
    straight = trainer.train(_cfg(speaker_root, tmp_path, *extra), "r", "cpu")
    last = straight["checkpoint"]
    kept = (read_pth(last), torch.load(C.resume_path(last), weights_only=True))
    first = glob.glob(os.path.join(straight["output_dir"], "checkpoints",
                                   "checkpoint_epoch-1_step-1.pth"))[0]
    resumed = trainer.train(_cfg(speaker_root, tmp_path, *extra), "r", "cpu",
                            resume_from=first)
    assert resumed["checkpoint"] == last and resumed["losses"] == straight["losses"]
    assert {"D_pose_gan_loss", "G_pose_gan_loss"} <= set(straight["losses"])
    again = read_pth(last)
    assert any(k.startswith("netD_pose.") for k in again) and "clips_code" not in again
    assert all(torch.equal(again[k], kept[0][k]) for k in kept[0])
    resume = torch.load(C.resume_path(last), weights_only=True)
    assert len(resume["optimizers"]) == len(resume["schedulers"]) == 2
    for oa, ob in zip(resume["optimizers"], kept[1]["optimizers"]):
        for sa, sb in zip(oa["state"].values(), ob["state"].values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_s2g_chunked_schedule_equals_one_step_at_a_time(speaker_root, tmp_path):
    """K = 3 steps a chunk on an epoch of 4 (a chunk of 3 and a remainder of
    1), from the cache (``speaker_stat_global`` staged with the rest): the
    losses and every weight, D's and the BN statistics included, bit for bit
    the per-step run's. (Chunks across epochs: tests/test_torch_port_device_cache.py.)"""
    opts = ["TRAIN.NUM_EPOCHS", "1", "DATASET.CACHING", "True", "DATASET.DEVICE_CACHE", "on"]
    one = trainer.train(_cfg(speaker_root, tmp_path, *opts), "k1", "cpu")
    three = trainer.train(_cfg(speaker_root, tmp_path, *opts, "TRAIN.STEPS_PER_DISPATCH", "3"),
                          "k3", "cpu")
    assert one["steps"] == three["steps"] == 4 and one["losses"] == three["losses"]
    a, b = read_pth(one["checkpoint"]), read_pth(three["checkpoint"])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_s2g_pretrain_from_starts_from_the_weights_with_fresh_optimizers(speaker_root,
                                                                          tmp_path):
    """``--pretrain_from`` an s2g .pth: the new run starts from its generator's
    and discriminator's weights (at LR 0 they stay so; BN statistics move
    with the step), with fresh Adams (one step counted, not two)."""
    extra = ["TRAIN.NUM_EPOCHS", "1", "DATASET.SUBSET", "2"]
    first = trainer.train(_cfg(speaker_root, tmp_path, *extra), "a", "cpu")
    again = trainer.train(_cfg(speaker_root, tmp_path, *extra, "TRAIN.LR", "0.0",
                               "TRAIN.PRETRAIN_FROM", first["checkpoint"]), "b", "cpu")
    a, b = read_pth(first["checkpoint"]), read_pth(again["checkpoint"])
    weights = [k for k in a if k.endswith(("conv.weight", "seq.3.weight", "norm.weight"))]
    assert any(k.startswith("netD_pose.") for k in weights)
    assert all(torch.equal(a[k], b[k]) for k in weights)
    resume = torch.load(C.resume_path(again["checkpoint"]), weights_only=True)
    steps = {float(st["step"]) for o in resume["optimizers"] for st in o["state"].values()}
    assert len(resume["optimizers"]) == 2 and steps == {1.0}
