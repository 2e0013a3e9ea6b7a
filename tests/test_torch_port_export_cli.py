"""The serving export's command lines on the CPU: ``main --export``, the
standalone runner ``run_artifact.py`` against the serving command line, and a
streaming session driven by a window-length artifact."""

import contextlib
import io
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch import main as port_main
from speechdrivestemplates_tpu_torch import run_artifact, serving
from speechdrivestemplates_tpu_torch.config import sdt_bp
from speechdrivestemplates_tpu_torch.models import build_model
from speechdrivestemplates_tpu_torch.ops.longform import SAMPLES_PER_FRAME
from speechdrivestemplates_tpu_torch.utils.export import export_serving_fn, load_serving_fn
from speechdrivestemplates_tpu_torch.utils.streaming import StreamingPoseSession
from speechdrivestemplates_tpu_torch.utils.weights import load_reference_pth

ROOT = os.path.join(os.path.dirname(__file__), "..")
RUNNER = os.path.join(ROOT, "speechdrivestemplates_tpu_torch", "run_artifact.py")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A seeded SDT-BP .pth, a wav, and ``main --device cpu --export`` of the
    .pth with the default preset (bf16, B = 1, DATASET.AUDIO_LENGTH): the
    serving command line's function."""
    tmp = tmp_path_factory.mktemp("export_cli")
    sd = build_model("SequenceGeneratorCNN", sdt_bp(), device="cpu",
                     generator=torch.Generator().manual_seed(7)).state_dict()
    ckpt = str(tmp / "bp.pth")
    torch.save({"epoch": 0, "step": 0,
                "model_state_dict": {"module.netG." + k: v for k, v in sd.items()}}, ckpt)
    wav_path = str(tmp / "in.wav")
    pcm = (np.random.RandomState(1).randn(40000) * 3000).astype(np.int16)  # padded
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    art = str(tmp / "bp.pt2")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = port_main.main(["--device", "cpu", "--export", art, "--checkpoint", ckpt])
    return dict(tmp=tmp, ckpt=ckpt, wav=wav_path, art=art, summary=summary,
                line=out.getvalue().strip().splitlines()[-1])


def test_main_export_writes_the_artifact_and_its_json_line(cli):
    line = json.loads(cli["line"])
    with open(cli["art"] + ".json") as f:
        assert json.load(f) == line == cli["summary"]
    assert os.path.getsize(cli["art"]) == line["bytes"]
    assert (line["batch_size"], line["audio_length"], line["device"], line["ops"]) == (
        1, sdt_bp().DATASET.AUDIO_LENGTH, "cpu", {})


def test_main_export_needs_a_checkpoint_and_refuses_pose2pose(cli, capsys):
    art = str(cli["tmp"] / "refused.pt2")
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--export", art])
    assert "need --checkpoint" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--config_file", "configs/pose2pose.yaml",
                        "--export", art, "--checkpoint", cli["ckpt"]])
    assert "has no audio input" in capsys.readouterr().err
    assert not os.path.exists(art)


def test_runner_writes_the_serving_command_lines_npz(cli):
    out, ref = str(cli["tmp"] / "runner.npz"), str(cli["tmp"] / "serving.npz")
    r = subprocess.run([sys.executable, RUNNER, cli["art"], cli["wav"], out, "--device", "cpu",
                        "--code-seed", "5", "--bench", "2"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    serving.main([cli["ckpt"], cli["wav"], ref, "--code-seed", "5", "--device", "cpu"])
    with np.load(out) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["poses"].shape == (64, 2, 121)
        np.testing.assert_array_equal(a["poses"], b["poses"])
        assert str(a["speaker"]) == str(b["speaker"]) == "oliver"
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "batch", "per_call_ms", "device"}
    assert (rec["metric"], rec["unit"], rec["batch"], rec["device"]) == (
        "served_frames_per_sec", "frames/s", 1, "cpu")
    assert rec["per_call_ms"] > 0 and rec["value"] > 0


def test_runner_refuses_another_device_than_the_artifacts(cli, tmp_path):
    """An artifact loads on the device it was exported for, and the runner's
    default is the card: a CPU artifact needs ``--device cpu``; one whose
    sidecar says cuda is refused on the CPU and, without a card, raises on the
    card, before its graph is read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a CUDA artifact would load on it")
    out = str(tmp_path / "x.npz")
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(ValueError, match="exported for cpu and loads there only"):
            run_artifact.main([cli["art"], cli["wav"], out, *device])
    cuda_art = str(tmp_path / "cuda.pt2")
    with open(cli["art"] + ".json") as f:
        meta = dict(json.load(f), device="cuda")
    with open(cuda_art + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_artifact.main([cuda_art, cli["wav"], out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_fn(cuda_art)
    with pytest.raises(ValueError, match="exported for cuda and loads there only"):
        load_serving_fn(cuda_art, "cpu")
    assert not os.path.exists(out)


def test_streaming_session_runs_off_a_window_artifact(cli):
    """The session takes a B = 1 artifact exported at the window's length as
    its forward, and streams what ``build_serving_fn`` streams, bit for bit."""
    cfg = sdt_bp(precision="fp32")
    window = int(64 * SAMPLES_PER_FRAME)
    art_path = str(cli["tmp"] / "window.pt2")
    export_serving_fn(cfg, cli["ckpt"], art_path, audio_length=window, device="cpu")
    art = load_serving_fn(art_path)
    fn, _ = serving.build_serving_fn(cfg, load_reference_pth(cli["ckpt"]), "cpu")
    code = np.random.RandomState(4).randn(1, 32).astype(np.float32)
    rng = np.random.RandomState(6)
    audio = (np.sin(np.arange(96000) * 0.05) * 0.1 + rng.randn(96000) * 0.02).astype(np.float32)

    def stream(forward):
        sess = StreamingPoseSession(lambda a: forward(a, code).float().cpu().numpy())
        got = [sess.feed(audio[i: i + 8000]) for i in range(0, len(audio), 8000)]
        return np.concatenate([g for g in got + [sess.flush()] if g.size])

    got, ref = stream(art), stream(fn)
    assert got.shape == (90, 2, 121)
    np.testing.assert_array_equal(got, ref)
