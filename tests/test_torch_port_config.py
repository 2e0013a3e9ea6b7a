"""The port's presets against the JAX package's config tree: for every key the
port has, each preset equals ``get_cfg_defaults()`` merged with the
``configs/*.yaml`` of its name. The one stated exception is TRAIN.PRECISION on
the Voice2Pose presets, which the port keeps at its bf16 flagship precision.
The presets take DATASET.SPEAKER as an argument (the port's default is
'oliver'); the YAML files leave it unset, so the comparison passes None."""

import dataclasses
import os

import pytest

from speechdrivestemplates_tpu_torch import config as C

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _leaves(node, prefix=()):
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, prefix + (f.name,))
        else:
            yield prefix + (f.name,), value


@pytest.mark.parametrize("name", sorted(C.PRESETS))
def test_preset_equals_the_jax_config_file(name):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    ref = get_cfg_defaults()
    ref.merge_from_file(os.path.join(CONFIG_DIR, f"{name}.yaml"))
    cfg = C.PRESETS[name](speaker=None)
    exceptions = {("TRAIN", "PRECISION")} if ref.PIPELINE_TYPE == "Voice2Pose" else set()
    checked = 0
    for path, value in _leaves(cfg):
        want = ref
        for part in path:
            want = want[part]
        if path in exceptions:
            assert (value, want) == ("bf16", "fp32")
            continue
        assert value == want and (value is None) == (want is None), (".".join(path), value, want)
        checked += 1
    assert checked >= 50
    assert cfg.PIPELINE_TYPE == ref.PIPELINE_TYPE
    assert C.PRESETS[name]().DATASET.SPEAKER == "oliver"


def test_config_file_names_pick_the_presets(tmp_path):
    """Each ``configs/<name>.yaml``, read by ``load_config``, is the preset of
    that name, and no file is SDT-BP. A file of another name is read as JAX
    reads it (when the port picked a preset by the file's name, it raised
    ValueError for one)."""
    for name, fn in C.PRESETS.items():
        assert C.load_config(os.path.join(CONFIG_DIR, f"{name}.yaml")) == fn()
    assert C.load_config("") == C.load_config(None) == C.sdt_bp()
    vae = C.load_config(os.path.join(CONFIG_DIR, "voice2pose_sdt_vae.yaml"))
    assert vae.VOICE2POSE.GENERATOR.CLIP_CODE.EXTERNAL_CODE
    assert C.pose2pose().TRAIN.PRECISION == "fp32" and C.sdt_vae().TRAIN.PRECISION == "bf16"
    g = C.load_config(os.path.join(CONFIG_DIR, "voice2pose_s2g.yaml"))
    assert g == C.s2g() and g.TRAIN.PRECISION == "bf16" and g.VOICE2POSE.GENERATOR.NORM == "BN"
    assert g.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION is None
    assert g.VOICE2POSE.POSE_DISCRIMINATOR.NAME == "PoseSequenceDiscriminator"
    mine = tmp_path / "my_model.yaml"
    mine.write_text(open(os.path.join(CONFIG_DIR, "voice2pose_s2g.yaml")).read())
    assert C.load_config(str(mine)) == C.s2g()


def test_new_keys_parse_like_yacs():
    """The keys this slice added take their values as yacs' merge_from_list
    does: None-valued keys take any literal."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    opts = ["TEST.BATCH_SIZE", "2", "TEST.MULTIPLE", "3", "TEST.SAVE_NPZ", "False",
            "DEMO.CODE_INDEX", "4", "DEMO.CODE_INDEX_B", "5", "POSE2POSE.LAMBDA_KL", "1",
            "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", "/ckpt/ae.pth",
            "VOICE2POSE.GENERATOR.CLIP_CODE.SAMPLE_FROM_NORMAL", "True",
            "VOICE2POSE.GENERATOR.CLIP_CODE.EXTERNAL_CODE_PTH", "/ckpt/p2p.pth",
            "TRAIN.NUM_RESULT_SAMPLE", "4", "PIPELINE_TYPE", "Pose2Pose"]
    cfg = C.apply_overrides(C.sdt_bp(), list(opts))
    ref = get_cfg_defaults()
    ref.merge_from_list(list(opts))
    for key in opts[0::2]:
        got, want = cfg, ref
        for part in key.split("."):
            got, want = getattr(got, part), want[part]
        assert got == want and type(got) is type(want), (key, got, want)


@pytest.mark.parametrize("opts", [
    ["VOICE2POSE.POSE_DISCRIMINATOR.WHITE_LIST", "[3, 71, 75]",
     "VOICE2POSE.POSE_DISCRIMINATOR.LAMBDA_GAN", "1", "VOICE2POSE.POSE_DISCRIMINATOR.MOTION",
     "False", "VOICE2POSE.POSE_DISCRIMINATOR.LEAKY_RELU", "True"],
    ["VOICE2POSE.POSE_DISCRIMINATOR.WHITE_LIST", "(0, 1)",
     "VOICE2POSE.POSE_DISCRIMINATOR.LAMBDA_GAN", "0.5"]], ids=["list", "tuple"])
def test_discriminator_keys_parse_like_yacs(opts):
    """POSE_DISCRIMINATOR's keys have the JAX defaults (LEAKY_RELU False,
    LAMBDA_GAN 1.0, MOTION True, WHITE_LIST None) on every preset but s2g, and
    take command-line values as yacs' merge_from_list does: WHITE_LIST, None
    by default, a list or a tuple of keypoint indices; an int LAMBDA_GAN as a
    float."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    ref = get_cfg_defaults()
    d = ref.VOICE2POSE.POSE_DISCRIMINATOR
    for name, preset in C.PRESETS.items():
        got = preset().VOICE2POSE.POSE_DISCRIMINATOR
        if name != "voice2pose_s2g":
            assert (got.LEAKY_RELU, got.LAMBDA_GAN, got.MOTION, got.WHITE_LIST) == \
                (d.LEAKY_RELU, d.LAMBDA_GAN, d.MOTION, d.WHITE_LIST), name
    cfg = C.apply_overrides(C.s2g(), list(opts))
    ref.merge_from_list(list(opts))
    for key in opts[0::2]:
        got, want = cfg, ref
        for part in key.split("."):
            got, want = getattr(got, part), want[part]
        assert got == want and type(got) is type(want), (key, got, want)


def test_trainer_option_keys_have_the_jax_defaults_and_parse_like_yacs():
    """The keys of the trainer's options (resume and pretrain, preemption,
    the caches, K steps a dispatch, the profiler window) exist with the JAX
    defaults on every preset, and take command-line values as yacs'
    merge_from_list does."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    ref = get_cfg_defaults()
    keys = ["DATASET.CACHING", "DATASET.DEVICE_CACHE", "DATASET.DEVICE_CACHE_MAX_MB",
            "TRAIN.PRETRAIN_FROM", "TRAIN.AUTO_RESUME", "TRAIN.CHECKPOINT_ON_PREEMPT",
            "TRAIN.STEPS_PER_DISPATCH", "SYS.PROFILE.ENABLED", "SYS.PROFILE.START_STEP",
            "SYS.PROFILE.NUM_STEPS", "SYS.PROFILE.OUT_DIR"]

    def get(node, key, index):
        for part in key.split("."):
            node = node[part] if index else getattr(node, part)
        return node

    for preset in C.PRESETS.values():
        for key in keys:
            got, want = get(preset(), key, False), get(ref, key, True)
            assert got == want and type(got) is type(want), (key, got, want)
    opts = ["DATASET.CACHING", "True", "DATASET.DEVICE_CACHE", "on",
            "DATASET.DEVICE_CACHE_MAX_MB", "512", "TRAIN.PRETRAIN_FROM", "/ckpt/a.pth",
            "TRAIN.AUTO_RESUME", "True", "TRAIN.CHECKPOINT_ON_PREEMPT", "False",
            "TRAIN.STEPS_PER_DISPATCH", "8", "SYS.PROFILE.ENABLED", "True",
            "SYS.PROFILE.START_STEP", "20", "SYS.PROFILE.NUM_STEPS", "3",
            "SYS.PROFILE.OUT_DIR", "/tmp/prof"]
    cfg = C.apply_overrides(C.sdt_bp(), list(opts))
    ref.merge_from_list(list(opts))
    for key in opts[0::2]:
        got, want = get(cfg, key, False), get(ref, key, True)
        assert got == want and type(got) is type(want), (key, got, want)
    with pytest.raises(ValueError, match="Type mismatch"):
        C.apply_overrides(C.sdt_bp(), ["TRAIN.STEPS_PER_DISPATCH", "2.5"])
