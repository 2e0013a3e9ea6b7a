"""DATASET.CACHING and DATASET.DEVICE_CACHE in the port, and the chunked
schedule of TRAIN.STEPS_PER_DISPATCH, on the CPU.

The SoA arrays against the per-item collate and the JAX dataset's
``materialize``; the cached trajectory against the host path, and the K = 3
chunked schedule (remainder included) against one step at a time, bit for
bit; the eligibility gates with the JAX reasons (``tests/test_device_cache.py``
holds the JAX trainer to the same)."""

import glob
import os

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, sdt_bp
from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import (CachedLoader,
                                                                      GestureDataset, collate)
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines.checkpoint import resume_path
from speechdrivestemplates_tpu_torch.utils.weights import read_pth


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("devcache") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=0, seed=4)
    return root


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU steps run fastest on one intra-op thread, and the suite runs
    several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(preset, root, out, *opts):
    return apply_overrides(preset(precision="fp32"), [
        "DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", str(out), "TRAIN.BATCH_SIZE", "2",
        "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0",
        "TRAIN.NUM_EPOCHS", "2", *opts])


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_materialize_and_gather_equal_the_per_item_collate(speaker_root):
    cached = GestureDataset(speaker_root, "oliver",
                            apply_overrides(sdt_bp(), ["DATASET.CACHING", "True"]))
    plain = GestureDataset(speaker_root, "oliver", sdt_bp())
    assert plain.materialize() is None
    soa = cached.materialize()
    assert cached.materialize() is soa and not cached._cache  # built once, items dropped
    assert soa["audio"].shape == (8, 68266) and soa["poses"].shape == (8, 64, 2, 121)
    _assert_tree_equal(soa, {k: v.numpy() if not isinstance(v, dict) else
                             {kk: vv.numpy() for kk, vv in v.items()}
                             for k, v in collate([plain[i] for i in range(8)]).items()})
    for idx in ([3, 0], [7, 5, 5, 1]):
        want = collate([plain[i] for i in idx])
        _assert_tree_equal(cached.gather(idx), {
            k: v.numpy() if not isinstance(v, dict) else {kk: vv.numpy() for kk, vv in v.items()}
            for k, v in want.items()})
        _assert_tree_equal({"x": cached[idx[0]]["poses"]}, {"x": plain[idx[0]]["poses"]})


def test_materialize_matches_the_jax_dataset(speaker_root):
    """The SoA arrays the port stages equal the JAX ``GestureDataset
    .materialize()`` on the same speaker, key by key (JAX keeps clip_index in
    int32, the port in int64, as its per-item path does)."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JaxDataset

    jcfg = get_cfg_defaults()
    jcfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                      "voice2pose_sdt_bp.yaml"))
    jcfg.DATASET.SPEAKER = "oliver"
    jcfg.DATASET.CACHING = True
    jsoa = JaxDataset(speaker_root, "oliver", "train", jcfg).materialize()
    soa = GestureDataset(speaker_root, "oliver",
                         apply_overrides(sdt_bp(), ["DATASET.CACHING", "True"])).materialize()
    for k in ("audio", "poses"):
        np.testing.assert_array_equal(soa[k], jsoa[k], err_msg=k)
    np.testing.assert_array_equal(soa["clip_index"], jsoa["clip_index"].astype(np.int64))
    for k in soa["speaker_stat"]:
        np.testing.assert_array_equal(soa["speaker_stat"][k], jsoa["speaker_stat"][k], err_msg=k)


def test_cache_on_equals_cache_off_over_two_epochs(speaker_root, tmp_path):
    """The host loader against the train set staged 'on' the device (here
    the CPU), Pose2Pose: the same batches by index, so the same weights,
    banks, norm statistics, optimizer moments and losses, bit for bit (the
    gather is the same for Voice2Pose's audio: the SoA test above)."""
    off = trainer.train(_cfg(pose2pose, speaker_root, tmp_path, "DATASET.DEVICE_CACHE", "off"),
                        "off", "cpu")
    on = trainer.train(_cfg(pose2pose, speaker_root, tmp_path, "DATASET.CACHING", "True",
                            "DATASET.DEVICE_CACHE", "on"), "on", "cpu")
    with open(os.path.join(on["output_dir"], "on.log")) as f:
        assert "device-resident train cache engaged" in f.read()
    assert off["losses"] == on["losses"]
    a, b = read_pth(off["checkpoint"]), read_pth(on["checkpoint"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    ra, rb = (torch.load(resume_path(c), weights_only=True)
              for c in (off["checkpoint"], on["checkpoint"]))
    for oa, ob in zip(ra["optimizers"], rb["optimizers"]):
        for sa, sb in zip(oa["state"].values(), ob["state"].values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _train_log(out, tag):
    with open(os.path.join(out["output_dir"], f"{tag}.log")) as f:
        return f.read()


def test_chunked_schedule_equals_one_step_at_a_time(speaker_root, tmp_path):
    """K = 3 on an epoch of 4 steps (a chunk of 3 and a remainder of 1), two
    epochs, from the cache: bit for bit the per-step run; every step's loss
    row is logged at its own global step, as the JAX chunked epoch does."""
    opts = ["DATASET.CACHING", "True", "DATASET.DEVICE_CACHE", "on", "SYS.LOG_INTERVAL", "1"]
    one = trainer.train(_cfg(pose2pose, speaker_root, tmp_path, *opts), "k1", "cpu")
    three = trainer.train(_cfg(pose2pose, speaker_root, tmp_path, *opts,
                               "TRAIN.STEPS_PER_DISPATCH", "3"), "k3", "cpu")
    assert one["losses"] == three["losses"] and one["steps"] == three["steps"] == 8
    a, b = read_pth(one["checkpoint"]), read_pth(three["checkpoint"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    lines = [[ln.split("] ", 1)[1] for ln in _train_log(r, tag).splitlines()
              if "[TRAIN] epoch: " in ln] for r, tag in ((one, "k1"), (three, "k3"))]
    strip = [[ln.split("  time: ")[0] + ln.split("  time: ")[1].split("  ", 1)[1] for ln in ls]
             for ls in lines]
    assert strip[0] == strip[1] and len(strip[0]) == 8
    assert [int(ln.split("global_step: ")[1].split()[0]) for ln in lines[1]] == list(range(1, 9))

    every2 = trainer.train(_cfg(pose2pose, speaker_root, tmp_path, *opts[:-2],
                                "SYS.LOG_INTERVAL", "2", "TRAIN.STEPS_PER_DISPATCH", "3",
                                "TRAIN.NUM_EPOCHS", "1"), "k3log2", "cpu")
    steps = [ln.split("global_step: ")[1].split()[0] for ln in
             _train_log(every2, "k3log2").splitlines() if "[TRAIN] epoch: " in ln]
    assert steps == ["2", "4"]


def test_steps_per_dispatch_without_the_cache_runs_per_step(speaker_root, tmp_path):
    """K > 1 where the cache cannot engage: the JAX warning, once, and the
    per-step trajectory."""
    one = trainer.train(_cfg(pose2pose, speaker_root, tmp_path), "p1", "cpu")
    three = trainer.train(_cfg(pose2pose, speaker_root, tmp_path,
                               "TRAIN.STEPS_PER_DISPATCH", "3"), "p3", "cpu")
    log = _train_log(three, "p3")
    assert log.count("TRAIN.STEPS_PER_DISPATCH=3 needs the device-resident train cache "
                     "(needs DATASET.CACHING (SoA arrays)); falling back to one dispatch "
                     "per step") == 1
    assert one["losses"] == three["losses"]


def test_device_cache_eligibility_gates(speaker_root, tmp_path):
    """'auto' falls back with the reason logged, 'on' raises with it before
    anything is written; the size cap; the val loader never engages it; an
    unknown mode is refused."""
    keys = trainer.PIPELINES["Pose2Pose"].device_keys
    cases = [(["DATASET.CACHING", "False"], "needs DATASET.CACHING (SoA arrays)"),
             (["DATASET.CACHING", "True", "TRAIN.SAVE_NPZ", "True"],
              "per-step artifact saving needs host batches"),
             (["DATASET.CACHING", "True", "DATASET.DEVICE_CACHE_MAX_MB", "0"],
              "exceeds DATASET.DEVICE_CACHE_MAX_MB (0 MB)"),
             (["DATASET.CACHING", "True", "DATASET.DEVICE_CACHE", "off"],
              "DATASET.DEVICE_CACHE off")]
    for opts, reason in cases:
        cfg = _cfg(pose2pose, speaker_root, tmp_path, *opts)
        loader = trainer.train_loader(cfg)
        cache, line = trainer.stage_device_cache(cfg, loader, torch.device("cpu"), keys)
        assert cache is None and reason in line, (opts, line)
        if "off" not in opts:
            on = apply_overrides(cfg, ["DATASET.DEVICE_CACHE", "on"])
            with pytest.raises(ValueError, match="DATASET.DEVICE_CACHE on, but: "):
                trainer.stage_device_cache(on, loader, torch.device("cpu"), keys)
            with pytest.raises(ValueError, match="DATASET.DEVICE_CACHE on, but: "):
                trainer.train(on, "refused", "cpu")
    assert not glob.glob(str(tmp_path / "*refused"))
    cfg = _cfg(pose2pose, speaker_root, tmp_path, "DATASET.CACHING", "True")
    loader = trainer.train_loader(cfg)
    assert isinstance(loader, CachedLoader)
    cache, line = trainer.stage_device_cache(cfg, loader, torch.device("cpu"), keys)
    assert set(cache) == set(keys) and cache["poses"].shape == (8, 64, 2, 121)
    assert line.startswith("device-resident train cache engaged")
    val = GestureDataset(speaker_root, "oliver", cfg, split="val")
    assert trainer.device_cache_reason(cfg, CachedLoader(val, loader.batch_sampler), keys) \
        == "not the train loader"
    assert trainer.device_cache_reason(cfg, loader, ()) == "pipeline declares no device keys"
    with pytest.raises(ValueError, match="DATASET.DEVICE_CACHE 'sometimes'"):
        trainer.train(apply_overrides(cfg, ["DATASET.DEVICE_CACHE", "sometimes"]), "x", "cpu")
