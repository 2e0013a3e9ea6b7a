"""Resume, auto-resume and preemption in the port's trainer, on the CPU.

N epochs straight against k epochs, ``--resume_from`` and N - k more, bit for
bit (weights, banks, BN statistics, both Adams, the schedulers, the noise
generator), for SDT-BP (fp32) and Pose2Pose; the refusals; the checkpoint
lookup against the JAX ``Trainer``'s static methods; a SIGTERM in a
subprocess (exit 143, an epoch-(E-1) checkpoint) and TRAIN.AUTO_RESUME
continuing it, as ``tests/test_cli.py`` holds the JAX command line to.
``tests/test_torch_port_pretrain.py`` holds ``--pretrain_from``.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import threading

import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, sdt_bp
from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
from speechdrivestemplates_tpu_torch.pipelines import checkpoint as C
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines.pose2pose import Pose2PoseTrainState
from speechdrivestemplates_tpu_torch.utils.weights import read_pth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=2, seed=6)
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
            "TEST.BATCH_SIZE", "2", "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False",
            "TEST.SAVE_NPZ", "False", "SYS.NUM_WORKERS", "0", *extra]


def _cfg(preset, root, out, *extra):
    return apply_overrides(preset(precision="fp32"), _opts(root, out, *extra))


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("preset,extra", [
    (pose2pose, ["TRAIN.VALIDATE", "True"]),
    (sdt_bp, ["TRAIN.VALIDATE", "False", "DATASET.SUBSET", "2"])], ids=["Pose2Pose", "SDT-BP"])
def test_resume_continues_the_run_bit_for_bit(speaker_root, tmp_path, preset, extra):
    """3 epochs straight, against the same run resumed from its epoch-1
    checkpoint: MultiStepLR's milestone 1 falls inside the resumed part.
    Pose2Pose takes 2 steps an epoch and a validation after each (its draws
    move the noise generator the train step draws from); SDT-BP one step an
    epoch on 2 clips. The last .pth, its resume file, the losses and the last
    validation agree bit for bit; the resumed run writes on in the same
    directory."""
    extra = ["TRAIN.NUM_EPOCHS", "3", *extra]
    straight = trainer.train(_cfg(preset, speaker_root, tmp_path, *extra), "r", "cpu")
    last, per_epoch = straight["checkpoint"], straight["steps"] // 3
    kept = (read_pth(last), torch.load(C.resume_path(last), weights_only=True))
    first = glob.glob(os.path.join(straight["output_dir"], "checkpoints",
                                   f"checkpoint_epoch-1_step-{per_epoch}.pth"))[0]
    resumed = trainer.train(_cfg(preset, speaker_root, tmp_path, *extra), "r", "cpu",
                            resume_from=first)
    assert resumed["resumed_from"] == first and resumed["checkpoint"] == last
    assert resumed["steps"] == straight["steps"] == 3 * per_epoch
    assert resumed["losses"] == straight["losses"]
    assert resumed.get("val_metrics") == straight.get("val_metrics")
    assert _equal(read_pth(last), kept[0])
    again = torch.load(C.resume_path(last), weights_only=True)
    assert _equal(again, kept[1]) and again["global_step"] == 3 * per_epoch
    assert again["epoch"] == 3
    assert len(again["optimizers"]) == (2 if preset is sdt_bp else 1)
    assert again["schedulers"][0]["last_epoch"] == 3
    with open(os.path.join(straight["output_dir"], "r.log")) as f:
        assert "Resuming from checkpoint" in f.read()


def test_resume_refusals(speaker_root, tmp_path):
    """A missing path, and a .pth without its resume file (a JAX export, a
    reference checkpoint), are refused before anything is written; the
    refusal names --pretrain_from."""
    cfg = _cfg(pose2pose, speaker_root, tmp_path / "runs", "TRAIN.NUM_EPOCHS", "1",
               "TRAIN.VALIDATE", "False")
    with pytest.raises(FileNotFoundError, match="--resume_from"):
        trainer.train(cfg, "x", "cpu", resume_from=str(tmp_path / "missing.pth"))
    state = Pose2PoseTrainState(cfg, 4, "cpu")
    bare = str(tmp_path / "checkpoint_epoch-3_step-9.pth")
    state.save_checkpoint(bare, 3, 9)
    with pytest.raises(ValueError, match=r"--pretrain_from .*checkpoint_epoch-3_step-9\.pth"):
        trainer.train(cfg, "x", "cpu", resume_from=bare)
    with pytest.raises(FileNotFoundError, match="PRETRAIN_FROM"):
        trainer.train(apply_overrides(cfg, ["TRAIN.PRETRAIN_FROM", str(tmp_path / "no.pth")]),
                      "x", "cpu")
    assert not (tmp_path / "runs").exists()


def _tree(root, suffix):
    """One tree of run directories: exact-tag matches, a prefix-sharing tag,
    unstamped and checkpoint-less directories, an unparseable entry."""
    layout = {
        "2026-10-16_10-00-00-123456_run": ["checkpoint_epoch-2_step-10",
                                           "checkpoint_epoch-10_step-50",
                                           "checkpoint_epoch-9_step-45"],
        "2026-10-17_11-00-00-000001_run": ["checkpoint_epoch-3_step-15",
                                           "checkpoint_epoch-10_step-51"],
        "2026-10-17_11-00-00_my_run": ["checkpoint_epoch-99_step-999"],
        "2026-10-17_12-00-00-5_run": ["checkpoint_garbage"],
        "notastamp_run": ["checkpoint_epoch-50_step-500"],
        "2026-10-18_09-00-00-7_run": [],
    }
    for d, entries in layout.items():
        os.makedirs(os.path.join(root, d, "checkpoints"))
        for e in entries:
            path = os.path.join(root, d, "checkpoints", e + suffix)
            if suffix:
                open(path, "w").close()
                open(C.resume_path(path), "w").close()
            else:
                os.makedirs(path)
    return layout


def test_checkpoint_lookup_matches_the_jax_trainer(tmp_path):
    """``find_auto_resume_candidates`` and ``resolve_checkpoint`` over .pth
    files return what the JAX ``Trainer``'s static methods return over orbax
    directories of the same names: the exact tag, newest (epoch, step)
    first by number, unparseable names left out; the newest checkpoint of a
    run directory or its ``checkpoints/``; a checkpoint as given."""
    from speechdrivestemplates_tpu.pipelines.trainer import Trainer

    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    layout = _tree(jroot, "")
    _tree(proot, ".pth")

    def rel(paths, root, suffix=""):
        return [os.path.relpath(p, root)[: len(os.path.relpath(p, root)) - len(suffix)]
                for p in paths]

    for tag in ("run", "my_run", "missing"):
        want = rel(Trainer.find_auto_resume_candidates(jroot, tag), jroot)
        assert rel(C.find_auto_resume_candidates(proot, tag), proot, ".pth") == want, tag
    assert rel(C.find_auto_resume_candidates(proot, "run"), proot, ".pth")[:3] == [
        "2026-10-17_11-00-00-000001_run/checkpoints/checkpoint_epoch-10_step-51",
        "2026-10-16_10-00-00-123456_run/checkpoints/checkpoint_epoch-10_step-50",
        "2026-10-16_10-00-00-123456_run/checkpoints/checkpoint_epoch-9_step-45"]
    for d in layout:
        if not layout[d]:
            with pytest.raises(FileNotFoundError):
                C.resolve_checkpoint(os.path.join(proot, d))
            continue
        for sub in ("", "checkpoints"):
            want = rel([Trainer.resolve_checkpoint(os.path.join(jroot, d, sub))], jroot)
            got = rel([C.resolve_checkpoint(os.path.join(proot, d, sub))], proot, ".pth")
            assert got == want, (d, sub)
    one = os.path.join(proot, "notastamp_run", "checkpoints", "checkpoint_epoch-50_step-500.pth")
    assert C.resolve_checkpoint(one) == one
    assert C.checkpoint_key("checkpoint_epoch-10_step-51.pth") == (10, 51) == \
        Trainer._checkpoint_key("checkpoint_epoch-10_step-51")
    assert C.checkpoint_key("checkpoint_garbage.pth") == (-1, -1)


def test_auto_resume_skips_checkpoints_that_do_not_load(speaker_root, tmp_path, caplog):
    """TRAIN.AUTO_RESUME tries this tag's checkpoints newest first: a
    truncated .pth and a .pth without its resume file are skipped with the
    JAX log line, the next one continues the run."""
    cfg = _cfg(pose2pose, speaker_root, tmp_path, "TRAIN.NUM_EPOCHS", "3",
               "TRAIN.VALIDATE", "False")
    run = trainer.train(cfg, "auto", "cpu")
    ck = {e: glob.glob(os.path.join(run["output_dir"], "checkpoints",
                                    f"checkpoint_epoch-{e}_*.pth"))[0] for e in (1, 2, 3)}
    with open(ck[3], "r+b") as f:
        f.truncate(100)
    os.remove(C.resume_path(ck[2]))
    cont = trainer.train(apply_overrides(_cfg(pose2pose, speaker_root, tmp_path,
                                              "TRAIN.VALIDATE", "False"),
                                         ["TRAIN.NUM_EPOCHS", "3", "TRAIN.AUTO_RESUME", "True"]),
                         "auto", "cpu")
    assert cont["resumed_from"] == ck[1] and cont["steps"] == 6
    skipped = [r.getMessage() for r in caplog.records if "AUTO_RESUME: skipping" in r.getMessage()]
    assert len(skipped) == 2 and ck[3] in skipped[0] and ck[2] in skipped[1]
    assert any("AUTO_RESUME: continuing from " + ck[1] in r.getMessage() for r in caplog.records)
    fresh = trainer.train(apply_overrides(cfg, ["TRAIN.AUTO_RESUME", "True",
                                                "TRAIN.NUM_EPOCHS", "1"]), "other", "cpu")
    assert "resumed_from" not in fresh


def test_preemption_checkpoint_and_auto_resume(speaker_root, tmp_path):
    """SIGTERM to ``main --device cpu`` after its first logged step: exit 143,
    'Preemption checkpoint saved', one checkpoint stamped epoch E-1 with its
    resume file; the same command with TRAIN.AUTO_RESUME continues from that
    global step, redoes epoch E and finishes. A kill timer fails a wedged
    child rather than hang."""
    out = str(tmp_path / "out")
    common = ["--device", "cpu", "--config_file", "configs/pose2pose.yaml", "--tag", "pre",
              *_opts(speaker_root, out, "TRAIN.VALIDATE", "False", "TRAIN.AUTO_RESUME", "True",
                     "TRAIN.CHECKPOINT_INTERVAL", "1000", "SYS.LOG_INTERVAL", "1",
                     "DATASET.CACHING", "True", "TRAIN.STEPS_PER_DISPATCH", "2")]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "speechdrivestemplates_tpu_torch.main"]
    proc = subprocess.Popen([*cmd, *common, "TRAIN.NUM_EPOCHS", "500"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(120, proc.kill)
    killer.daemon = True
    killer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "global_step" in line:
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines) + rest
    assert proc.returncode == 143, (proc.returncode, text[-3000:])
    assert "Preemption checkpoint saved" in text
    ckpts = glob.glob(os.path.join(out, "*_pose2pose-TRAIN-pre", "checkpoints", "*.pth"))
    assert len(ckpts) == 1 and os.path.exists(C.resume_path(ckpts[0])), ckpts
    epoch, step = C.checkpoint_key(ckpts[0])
    assert epoch >= 0 and step >= 2 and step % 2 == 0  # after a whole chunk
    r = subprocess.run([*cmd, *common, "TRAIN.NUM_EPOCHS", str(epoch + 1)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["resumed_from"] == ckpts[0] and line["steps"] == step + 2
    shutil.rmtree(out)
