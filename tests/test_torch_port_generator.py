"""The port's SDT-BP generator and serving function against the JAX package,
on the CPU, with weights from one seeded JAX init carried over by
``params_from_jax``.
"""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu.models.generator import SequenceGeneratorCNN as JGen
from speechdrivestemplates_tpu.ops.mel import mel_spectrogram as jmel
from speechdrivestemplates_tpu_torch.config import sdt_bp
from speechdrivestemplates_tpu_torch.models import build_model
from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram as tmel
from speechdrivestemplates_tpu_torch.utils.weights import params_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module")
def jax_params():
    gen = JGen(num_landmarks=121, code_dim=32, norm="IN", leaky=True, dtype=None)
    init = jax.jit(gen.init, static_argnums=(2, 4))  # jitted: 3x faster on the CPU
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64)), 32,
                     jnp.zeros((1, 32)), False)
    return jax.tree.map(np.asarray, variables["params"])


def _port(precision, params):
    model = build_model("SequenceGeneratorCNN", sdt_bp(precision=precision),
                        device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _jax_forward(params, mel, T, code, dtype=None):
    gen = JGen(num_landmarks=121, code_dim=32, norm="IN", leaky=True, dtype=dtype)
    fn = jax.jit(lambda p, m, c: gen.apply({"params": p}, m, T, c, False))
    return np.asarray(fn(params, jnp.asarray(mel), jnp.asarray(code)), np.float32)


def test_port_state_dict_matches_jax_param_count(jax_params):
    model = _port("fp32", jax_params)
    n_jax = sum(np.size(a) for a in jax.tree.leaves(jax_params))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 7_075_122


def test_generator_fp32_matches_jax(rng, jax_params):
    B, T, t_mel = 2, 32, 64  # T >= 32: the UNet's five stride-2 downsamples
    mel = rng.randn(B, 80, t_mel).astype(np.float32)
    code = rng.randn(B, 32).astype(np.float32)
    ref = _jax_forward(jax_params, mel, T, code)
    with torch.no_grad():
        got = _port("fp32", jax_params)(torch.from_numpy(mel), T,
                                        torch.from_numpy(code)).numpy()
    assert got.shape == ref.shape == (B, T, 2, 121)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_generator_real_clip_matches_jax(rng, jax_params):
    """The slice as a whole at the real serving shape: a 68267-sample clip
    through each side's mel frontend and generator to 64 pose frames."""
    audio = (rng.randn(1, 68267) * 0.1).astype(np.float32)
    code = rng.randn(1, 32).astype(np.float32)
    jm = np.asarray(jmel(jnp.asarray(audio), impl="dft"))
    assert jm.shape == (1, 80, 427)
    ref = _jax_forward(jax_params, jm, 64, code)
    with torch.no_grad():
        got = _port("fp32", jax_params)(tmel(torch.from_numpy(audio)), 64,
                                        torch.from_numpy(code)).numpy()
    assert got.shape == ref.shape == (1, 64, 2, 121)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_generator_bf16_tracks_jax_bf16(rng, jax_params):
    """bf16 rounds at other places in the two frameworks (JAX normalizes in
    bf16, the port in fp32), so the two bf16 forwards are held to the bf16
    quantile gate of tests/test_stem_pallas.py, and the port's bf16 to its
    own fp32 by the relative-L2 gate of tests/test_precision.py."""
    B, T, t_mel = 2, 32, 64
    mel = rng.randn(B, 80, t_mel).astype(np.float32) * 2.0
    code = rng.randn(B, 32).astype(np.float32)
    ref = _jax_forward(jax_params, mel, T, code, dtype=jnp.bfloat16)
    with torch.no_grad():
        args = (torch.from_numpy(mel), T, torch.from_numpy(code))
        got = _port("bf16", jax_params)(*args).float().numpy()
        got32 = _port("fp32", jax_params)(*args).numpy()
    err = np.abs(got - ref)
    assert np.quantile(err, 0.99) < 0.05 and err.mean() < 0.02, (
        np.quantile(err, 0.99), err.mean())
    rel_l2 = np.linalg.norm(got - got32) / np.linalg.norm(got32)
    assert rel_l2 < 0.05, rel_l2


def _jax_cfg():
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.DATASET.SPEAKER = "oliver"
    cfg.freeze()
    return cfg


def _pixel_tolerance():
    """Pixel-space poses are normalized poses x std x scale, plus the part
    root's coordinates for re-rooted keypoints: the generator's atol of 1e-4
    grows by up to 2 x max(std) x scale (about 170 for 'oliver')."""
    from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat

    stat = get_speaker_stat("oliver", 121, True)
    return 2 * 1e-4 * float(stat["std"].max() * stat["scale_factor"])


def test_serving_fn_matches_jax(rng, jax_params):
    from speechdrivestemplates_tpu.utils.export import build_serving_fn as jserve
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    audio = (rng.randn(2, 68267) * 0.1).astype(np.float32)
    code = rng.randn(2, 32).astype(np.float32)
    jfn, jhas_code = jserve(_jax_cfg(), jax_params, {})
    ref = np.asarray(jax.jit(jfn)(jnp.asarray(audio), jnp.asarray(code)))
    fn, has_code = build_serving_fn(sdt_bp(precision="fp32"),
                                    params_from_jax(jax_params), device="cpu")
    got = fn(audio, code).numpy()
    assert has_code and jhas_code
    assert got.shape == ref.shape == (2, 64, 2, 121) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=_pixel_tolerance())


def test_cli_round_trip_from_jax_export(rng, jax_params, tmp_path, capsys):
    """JAX ``export_module_params`` + ``save_torch_checkpoint`` -> ``.pth`` ->
    the port's serving CLI on a seeded wav -> the in-process output."""
    from speechdrivestemplates_tpu.utils.torch_export import (
        export_module_params, reverse_generator, save_torch_checkpoint)
    from speechdrivestemplates_tpu_torch import serving
    from speechdrivestemplates_tpu_torch.utils.weights import load_reference_pth

    ckpt = str(tmp_path / "sdt_bp.pth")
    sd = export_module_params(jax_params, {}, "netG.", reverse_generator)
    sd["clips_code"] = rng.randn(4, 32).astype(np.float32)  # not the generator's
    save_torch_checkpoint(ckpt, sd, epoch=3, step=7)
    loaded = load_reference_pth(ckpt)
    for k, v in params_from_jax(jax_params).items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    assert set(loaded) == set(params_from_jax(jax_params))

    wav_path = str(tmp_path / "in.wav")
    pcm = (rng.randn(40000) * 3000).astype(np.int16)  # shorter than 68267: padded
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    out = str(tmp_path / "out.npz")
    serving.main([ckpt, wav_path, out, "--code-seed", "5", "--device", "cpu"])
    assert "64 pose frames" in capsys.readouterr().out

    buf = np.zeros((1, 68267), np.float32)
    buf[0, :40000] = pcm.astype(np.float32) / 32768.0
    code = np.random.RandomState(5).randn(1, 32).astype(np.float32)
    fn, _ = serving.build_serving_fn(sdt_bp(), loaded, device="cpu")
    with np.load(out) as z:
        assert z["poses"].shape == (64, 2, 121) and str(z["speaker"]) == "oliver"
        np.testing.assert_array_equal(z["poses"], fn(buf, code)[0].numpy())
