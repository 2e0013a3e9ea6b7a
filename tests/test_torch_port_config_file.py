"""``--config_file`` read as the JAX ``main.py`` reads it, and JAX's run names.

``config.load_config`` (defaults, the YAML file, the overrides) against the
JAX package's ``get_cfg_defaults(); merge_from_file(path);
merge_from_list(opts)``, leaf for leaf over every key of both trees, for the
six ``configs/*.yaml`` and an edited copy. The stated exceptions: where the
file leaves them unset, TRAIN.PRECISION is bf16 for Voice2Pose (the port's
flagship precision) and DATASET.SPEAKER is 'oliver' (JAX's dataset refuses
None); TRAIN.WD is the float 0.0 where JAX has the int 0 (equal values; JAX's
int refuses ``TRAIN.WD 1e-3``). The subset YAML reader equals
``yaml.safe_load`` and raises, with the line, on what it does not cover. The
command line trains for the edited file's NUM_EPOCHS, names its runs with
JAX's ``exp_tag``, and TRAIN.AUTO_RESUME takes only its own config's
checkpoints."""

import dataclasses
import glob
import importlib.util
import json
import os
from types import SimpleNamespace

import pytest
import torch
import yaml

from speechdrivestemplates_tpu_torch import config as C
from speechdrivestemplates_tpu_torch import main as port_main
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
assert len(CONFIGS) == 6


def _leaves(node, prefix=()):
    for f in dataclasses.fields(node):
        value = getattr(node, f.name)
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, prefix + (f.name,))
        else:
            yield prefix + (f.name,), value


def _jax_leaves(node, prefix=()):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_cfg(path, opts=()):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(path)
    cfg.merge_from_list(list(opts))
    return cfg


def _edited(tmp_path, name="voice2pose_sdt_bp", extra="TRAIN:\n  NUM_EPOCHS: 3\n",
            replace=("", "")):
    path = tmp_path / f"{name}_edited.yaml"
    text = open(os.path.join(ROOT, "configs", f"{name}.yaml")).read()
    path.write_text(text.replace(*replace) + extra)
    return str(path)


def _assert_equal_to_jax(cfg, ref, tree):
    got, want = dict(_leaves(cfg)), dict(_jax_leaves(ref))
    assert sorted(got) == sorted(want)  # every JAX key, and no other
    exceptions = set()
    if ref.PIPELINE_TYPE == "Voice2Pose" and "PRECISION" not in (tree.get("TRAIN") or {}):
        exceptions.add(("TRAIN", "PRECISION"))
        assert (got[("TRAIN", "PRECISION")], want[("TRAIN", "PRECISION")]) == ("bf16", "fp32")
    if ref.DATASET.SPEAKER is None:
        exceptions.add(("DATASET", "SPEAKER"))
        assert got[("DATASET", "SPEAKER")] == "oliver"
    for path, w in want.items():
        if path in exceptions:
            continue
        g = got[path]
        assert g == w and (g is None) == (w is None), (".".join(path), g, w)
        if path != ("TRAIN", "WD") or type(w) is not int:
            assert type(g) is type(w), (".".join(path), type(g), type(w))
    return len(want)


@pytest.mark.parametrize("path", CONFIGS + ["edited"], ids=lambda p: os.path.basename(p))
def test_loaded_tree_equals_the_jax_tree(path, tmp_path):
    if path == "edited":
        path = _edited(tmp_path)
    opts = ["TRAIN.BATCH_SIZE", "8", "SYS.CANVAS_SIZE", "[360, 640]", "DATASET.SPEAKER",
            "kubinec", "SYS.VIDEO_FORMAT", "('mp4',)", "TRAIN.LR", "2"]
    tree = yaml.safe_load(open(path))
    for o in ((), opts):
        cfg = C.load_config(path, list(o))
        assert _assert_equal_to_jax(cfg, _jax_cfg(path, o), tree) == 95
    assert cfg.SYS.CANVAS_SIZE == (360, 640) and cfg.SYS.VIDEO_FORMAT == ["mp4"]
    assert C.load_config(path).TRAIN.NUM_EPOCHS == (3 if "edited" in path else 100)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_subset_reader_equals_safe_load_on_the_config_files(path):
    assert C.read_yaml(path) == yaml.safe_load(open(path))


@pytest.mark.parametrize("text", [
    "A: 1\nB:\n  C: 'x # y'  # a comment\n  D: \"a\\tb\"\n  E: [1, 2.5, 'mp4', \"img\", null]\n",
    "F: ~\nG: yes\nH: -3\nI: 1.\nJ: 1e4\nK: localhost:80\nL: []\nM:\nN: 'it''s'\nO: a/b\n",
    "P: -1.5e-3\nQ: [ 'a' , b, ]\nR: True\nS: off\nT: NULL\nU: 0\nV: a#b\nW: -x\n",
    "# comments only\n\n",
    "A:\n    B:\n        C: 1\n    D:\nE: x y z\n",
], ids=["scalars", "more-scalars", "signs-and-flow", "empty", "nesting"])
def test_subset_reader_equals_safe_load(text):
    assert C.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text, line", [
    ("A: 1\nB:\n  - 1\n", 3), ("A: &x 1\n", 1), ("A: *x\n", 1), ("A: |\n  x\n", 1),
    ("A: {a: 1}\n", 1), ("A: 1\nA: 2\n", 2), ("A: 'open\n", 1), ("A: [1, [2]]\n", 1),
    ("A: 0x10\n", 1), ("A: 010\n", 1), ("A: 1_000\n", 1), ("A: 2020-01-01\n", 1),
    ("A: .5\n", 1), ("A:\n\tB: 1\n", 2), ("---\nA: 1\n", 1), ("A: b: c\n", 1),
    ("'A': 1\n", 1), ("A: !!str 1\n", 1), ("A: [1,\n  2]\n", 1), ("A: 1\n B: 2\n", 2),
    ("A: \"\\x41\"\n", 1), ("A: 'a' b\n", 1)])
def test_subset_reader_raises_outside_the_subset(text, line):
    with pytest.raises(C.YAMLSubsetError, match=f"<yaml>:{line}: "):
        C.parse_yaml(text)


def test_keys_the_port_refuses_or_ignores(tmp_path):
    """A parallel key set in the file is read (item 14 is ported), and a
    SYS.MESH.DATA that is not the rank count raises; the XLA-only keys,
    CLIP_CODE.TRAIN and STRICT_LOADING are accepted and named as ignored;
    another dataset, an unknown video format, an unknown key and a type JAX
    refuses raise as JAX's merge does."""
    path = _edited(tmp_path, extra="SYS:\n  DISTRIBUTED: True\n")
    assert C.load_config(path).SYS.DISTRIBUTED is True
    path = _edited(tmp_path, extra="SYS:\n  MESH:\n    DATA: 4\n")
    with pytest.raises(ValueError, match="SYS.MESH.DATA 4 with SYS.WORLD_SIZE 1"):
        C.load_config(path)
    xla = ["SYS.MEL_IMPL", "dft", "SYS.FUSED_STEM", "True", "SYS.CONV_MM_GRAD", "True",
           "SYS.DEBUG_NANS", "True", "SYS.PLATFORM", "cpu", "SYS.COMPILE_CACHE_DIR", "''",
           "VOICE2POSE.GENERATOR.CLIP_CODE.TRAIN", "False", "VOICE2POSE.STRICT_LOADING", "False"]
    cfg = C.load_config(None, xla)
    assert sorted(k.split()[0] for k in C.ignored_keys(cfg)) == sorted(xla[0::2])
    assert C.ignored_keys(C.load_config(None)) == []
    with pytest.raises(ValueError, match="DATASET.NAME 'Other'"):
        C.load_config(None, ["DATASET.NAME", "Other"])
    with pytest.raises(ValueError, match="gif"):
        C.load_config(None, ["SYS.VIDEO_FORMAT", "['gif']"])
    with pytest.raises(KeyError, match="Non-existent config key: DATASET.NOPE"):
        C.load_config(_edited(tmp_path, extra="  NOPE: 1\n"))
    for opts in (["TRAIN.NUM_EPOCHS", "2.5"], ["SYS.CANVAS_SIZE", "'big'"]):
        with pytest.raises(ValueError, match="Type mismatch"):
            C.load_config(None, opts)
        with pytest.raises(ValueError, match="Type mismatch"):
            _jax_cfg(CONFIGS[0], opts)


def _jax_exp_tags(argv):
    """The ``exp_tag`` the JAX ``main.py`` hands its pipeline for ``argv``
    (its ``run``, with a pipeline that records instead of running)."""
    spec = importlib.util.spec_from_file_location("jax_main", os.path.join(ROOT, "main.py"))
    jax_main = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_main)
    seen = []
    record = SimpleNamespace(train=lambda cfg, tag, *a: seen.append(tag),
                             test=lambda cfg, tag, *a: seen.append(tag),
                             demo=lambda cfg, tag, *a: seen.append(tag))
    jax_main.get_pipeline = lambda name: (lambda cfg: record)
    args = SimpleNamespace(config_file="", export_torch=None, export=None, demo_input=None,
                           test_only=False, tag="", checkpoint=None, resume_from=None)
    for k, v in argv.items():
        setattr(args, k, v)
    jax_main.run(args, SimpleNamespace(SYS=SimpleNamespace(DEBUG_NANS=False),
                                       PIPELINE_TYPE="Pose2Pose"))
    return seen[0]


def test_cli_reads_the_file_and_names_runs_as_jax(tmp_path, capsys):
    """Pose2Pose, 4 clips, B = 2, on the CPU. An edited copy of
    ``configs/pose2pose.yaml`` with NUM_EPOCHS 2 trains 2 epochs. Runs are
    ``<datetime>_<exp_tag>`` with JAX's exp_tag. Config B (the edited copy)
    trains 1 epoch under tag "t", then configs/pose2pose.yaml 2 epochs under
    the same tag in the same OUTPUT_DIR (its epoch-2 checkpoint the newest of
    the directory); B with TRAIN.AUTO_RESUME then resumes B's own epoch-1
    checkpoint."""
    root = str(tmp_path / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=1, seed=3)
    out = str(tmp_path / "runs")
    b_file = _edited(tmp_path, "pose2pose", "", ("NUM_EPOCHS: 100", "NUM_EPOCHS: 2"))
    assert C.load_config(b_file).TRAIN.NUM_EPOCHS == 2
    common = ["DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", out, "TRAIN.BATCH_SIZE", "2",
              "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0"]

    def run(cfg_file, *opts):
        summary = port_main.main(["--device", "cpu", "--tag", "t", "--config_file", cfg_file,
                                  *common, *opts])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
            json.loads(json.dumps(summary))
        return summary

    b0 = run(b_file, "SYS.OUTPUT_DIR", str(tmp_path / "runs0"))
    assert b0["epochs"] == 2 and b0["steps"] == 4  # the file's NUM_EPOCHS
    b1 = run(b_file, "TRAIN.NUM_EPOCHS", "1")
    a2 = run(os.path.join(ROOT, "configs", "pose2pose.yaml"), "TRAIN.NUM_EPOCHS", "2")
    for summary, cfg_file in ((b1, b_file), (a2, "configs/pose2pose.yaml")):
        name = os.path.basename(summary["output_dir"])
        want = _jax_exp_tags({"config_file": cfg_file, "tag": "t"})
        assert name.split("_", 2)[2] == want and want.endswith("-TRAIN-t")
        assert os.path.exists(os.path.join(summary["output_dir"], f"{want}.log"))
    resumed = run(b_file, "TRAIN.NUM_EPOCHS", "2", "TRAIN.AUTO_RESUME", "True")
    assert resumed["resumed_from"] == b1["checkpoint"] and resumed["steps"] == 4
    assert resumed["output_dir"] == b1["output_dir"]
    assert os.path.basename(b1["checkpoint"]) == "checkpoint_epoch-1_step-2.pth"
    assert os.path.basename(a2["checkpoint"]) == "checkpoint_epoch-2_step-4.pth"
    for argv, mode in (({"test_only": True}, "TEST"), ({"demo_input": "x.wav"}, "DEMO"),
                       ({}, "TRAIN")):
        assert _jax_exp_tags({"config_file": "configs/voice2pose_s2g.yaml", **argv}) == \
            f"voice2pose_s2g-{mode}-"
    assert torch.load(resumed["checkpoint"], weights_only=True)["step"] == 4
