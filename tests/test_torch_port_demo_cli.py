"""The demo's command line against the JAX package's demo run, on the CPU:
``main --device cpu --demo_input <dir>`` with DEMO.MULTIPLE 3 on an SDT-BP
``.pth`` writes the JAX layout's nine archives with JAX's poses and codes;
and the serving command line reads a wav as the JAX loader does."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechdrivestemplates_tpu_torch import main as port_main
from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
PX_ATOL = 0.01  # px: the bound of tests/test_demo_bucketing.py
DEMO_OPTS = ["TEST.SAVE_VIDEO", "False", "TRAIN.PRECISION", "fp32", "DEMO.MULTIPLE", "3",
             "DEMO.CODE_INDEX", "0", "DEMO.CODE_INDEX_B", "1", "DEMO.NUM_SAMPLES", "3"]


@pytest.fixture(scope="module")
def bp_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo_cli")
    state = Voice2PoseTrainState(apply_overrides(sdt_bp(precision="fp32"), []), 4, "cpu")
    with torch.no_grad():
        state.clips_code.copy_(torch.from_numpy(
            np.random.RandomState(7).randn(4, 32).astype(np.float32)))
    path = str(tmp / "bp.pth")
    state.save_checkpoint(path, 1, 1)
    return path


def _wav(path, seconds, sr, dtype, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.1 * np.sin(2 * np.pi * (150 + 50 * seed) * t) * (1 + np.sin(2 * np.pi * 2 * t)) \
        + 0.02 * rng.randn(len(t))
    wavfile.write(path, sr, (x * 32767).astype(np.int16) if dtype == "int16"
                  else x.astype(np.float32))


def test_demo_cli_matches_jax_demo(tmp_path, bp_ckpt, capsys):
    """Three wavs (3 s at 16 kHz, 5.1 s at 44.1 kHz float, 6.9 s at 22.05 kHz),
    each three times with the code moved from bank row 0 to row 1: 64, 76 and
    103 frames through the dense route (JAX's with its default length bucket,
    the port's at each clip's own length)."""
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i, (sec, sr, dtype) in enumerate([(3.0, 16000, "int16"), (5.1, 44100, "float32"),
                                          (6.9, 22050, "int16")]):
        _wav(str(wavs / f"talk{i}.wav"), sec, sr, dtype, i)
    summary = port_main.main(["--device", "cpu", "--demo_input", str(wavs), "--checkpoint",
                              bp_ckpt, "--tag", "demo", "SYS.OUTPUT_DIR",
                              str(tmp_path / "port"), *DEMO_OPTS])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(summary))
    assert sorted(summary["num_frames"]) == [64, 76, 103] and len(summary["npz"]) == 9
    assert os.path.basename(summary["output_dir"]).endswith("_voice2pose_sdt_bp-DEMO-demo")

    jcfg = get_cfg_defaults()
    jcfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    jcfg.merge_from_list(["DATASET.SPEAKER", "oliver", "SYS.MESH.DATA", "1",
                          "SYS.OUTPUT_DIR", str(tmp_path / "jax"), *DEMO_OPTS])
    jcfg.freeze()
    get_pipeline("Voice2Pose")(jcfg).demo(jcfg, "demo", bp_ckpt, str(wavs))
    want = sorted(glob.glob(str(tmp_path / "jax" / "*" / "results" / "*.npz")))
    got = sorted(summary["npz"])
    names = [f"epoch0-DEMO-step{t}-{i}.npz" for t in (1, 2, 3) for i in range(3)]
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == names
    bank = torch.load(bp_ckpt, weights_only=True)["model_state_dict"]["module.clips_code"]
    for n, (p, w) in enumerate(zip(got, want)):
        with np.load(p) as zp, np.load(w) as zw:
            assert sorted(zp.files) == sorted(zw.files) == ["condition_code",
                                                            "poses_pred_batch"]
            assert zp["poses_pred_batch"].shape == zw["poses_pred_batch"].shape
            assert zp["poses_pred_batch"].shape[1] == summary["num_frames"][n // 3]
            np.testing.assert_allclose(zp["poses_pred_batch"], zw["poses_pred_batch"], rtol=0,
                                       atol=PX_ATOL)
            coeff = (n % 3) / 2
            np.testing.assert_allclose(zp["condition_code"][0],
                                       (bank[0] * (1 - coeff) + bank[1] * coeff).numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(zp["condition_code"], zw["condition_code"], rtol=1e-6,
                                       atol=1e-7)


def test_demo_cli_needs_a_checkpoint_and_refuses_what_is_not_ported(tmp_path, bp_ckpt):
    with pytest.raises(SystemExit):
        port_main.main(["--device", "cpu", "--demo_input", str(tmp_path)])
    # item 14 is ported: the parallel keys and DEMO.SEQUENCE_PARALLEL run; parallel keys that
    # map onto no ranks are refused before anything is written
    for opts in (["SYS.WORLD_SIZE", "0"],
                 ["TEST.SAVE_VIDEO", "False", "DEMO.SEQUENCE_PARALLEL", "True",
                  "SYS.MESH.DATA", "2"]):
        with pytest.raises(SystemExit):
            port_main.main(["--device", "cpu", "--demo_input", str(tmp_path), "--checkpoint",
                            bp_ckpt, "SYS.OUTPUT_DIR", str(tmp_path / "out"), *opts])
    assert not (tmp_path / "out").exists()


def test_serving_cli_reads_a_44k_float_wav_as_jax_does(tmp_path, bp_ckpt):
    """The serving command line's samples are the JAX loader's
    (resample_poly), not a linear interpolation: its poses equal the serving
    function's on ``speechdrivestemplates_tpu.utils.audio.load_wav``'s."""
    from speechdrivestemplates_tpu.utils.audio import load_wav as jax_load
    from speechdrivestemplates_tpu_torch import serving
    from speechdrivestemplates_tpu_torch.utils.weights import load_reference_pth

    wav = str(tmp_path / "talk.wav")
    _wav(wav, 3.2, 44100, "float32", 4)
    out = str(tmp_path / "poses.npz")
    serving.main([bp_ckpt, wav, out, "--device", "cpu", "--code-seed", "2"])
    cfg = sdt_bp()
    fn, _ = serving.build_serving_fn(cfg, load_reference_pth(bp_ckpt), "cpu")
    audio = jax_load(wav)
    buf = np.zeros((1, cfg.DATASET.AUDIO_LENGTH), np.float32)
    buf[0, : len(audio)] = audio
    want = fn(buf, np.random.RandomState(2).randn(1, 32).astype(np.float32))[0]
    with np.load(out) as z:
        np.testing.assert_array_equal(z["poses"], want.float().numpy())
