"""The PyTorch port's ops against the JAX package, on the CPU.

Same inputs (numpy, seeded) through the JAX function and the port's plain
PyTorch version: the mel frontend (the plain path of the fused STFT+mel CUDA
kernel), the static resizes, the IN-1d ConvNormRelu, the pose transforms and
the speaker statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speechdrivestemplates_tpu.ops import mel as jmel
from speechdrivestemplates_tpu_torch.ops import mel as tmel


def test_mel_tables_equal_jax():
    args = (jmel.SAMPLE_RATE, jmel.N_FFT, jmel.N_MELS, jmel.F_MIN, jmel.F_MAX)
    np.testing.assert_array_equal(tmel._mel_filterbank_np(*args),
                                  jmel._mel_filterbank_np(*args))
    np.testing.assert_array_equal(tmel._window_np(400, 512), jmel._window_np(400, 512))
    for a, b in zip(tmel._dft_matrices_np(512), jmel._dft_matrices_np(512)):
        np.testing.assert_array_equal(a, b)


def test_mel_kernel_tables_fold_window_into_dft():
    """The kernel's operands: the windowed DFT over the window's support, and
    the filterbank trimmed to 256 bins (exact: bins >= 240 carry no weight)."""
    cs, fb = tmel._kernel_tables_np()
    assert cs.shape == (400, 512) and fb.shape == (256, 80)
    full_fb = jmel._mel_filterbank_np(16000, 512, 80, 55.0, 7500.0)
    assert np.flatnonzero(full_fb.any(axis=1)).max() == 239
    np.testing.assert_array_equal(fb, full_fb[:256])
    win = jmel._window_np(400, 512)
    cos_m, sin_m = jmel._dft_matrices_np(512)
    ref = np.concatenate([cos_m[:, :256], sin_m[:, :256]], axis=1) * win[:, None]
    assert not ref[:56].any() and not ref[456:].any()  # zero taps the kernel skips
    np.testing.assert_allclose(cs, ref[56:456], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 16000), (1, 68267)])
def test_mel_plain_matches_jax_dft(rng, shape):
    audio = (rng.randn(*shape) * 0.1).astype(np.float32)
    ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(audio), impl="dft"))
    got = tmel.mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (shape[0], 80, shape[1] // 160 + 1)
    # the gate of tests/test_mel_pallas.py
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("in_len,out_len", [(2, 4), (5, 9), (51, 64), (64, 51), (7, 7)])
def test_linear_time_resize_matches_jax(rng, in_len, out_len):
    from speechdrivestemplates_tpu.ops.resize import (_resize_matrix,
                                                      interpolate_linear_time)
    from speechdrivestemplates_tpu_torch.ops import resize as tres

    np.testing.assert_array_equal(tres._resize_matrix(in_len, out_len),
                                  _resize_matrix(in_len, out_len))
    x = rng.randn(2, in_len, 6).astype(np.float32)  # JAX layout (B, T, C)
    ref = np.asarray(interpolate_linear_time(jnp.asarray(x), out_len))
    xt = torch.from_numpy(x).transpose(1, 2)
    got = tres.interpolate_linear_time(xt, out_len).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # torch computes each source coordinate in float32 (the matrices in float64),
    # so its lerp weights differ by ~1e-7 * index: up to ~1e-5 on O(1) values
    torch_ref = F.interpolate(xt, size=out_len, mode="linear", align_corners=False)
    np.testing.assert_allclose(got, torch_ref.transpose(1, 2).numpy(), rtol=1e-5,
                               atol=5e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 51), (1, 64)), ((3, 8), (6, 5))])
def test_bilinear_resize_matches_jax_without_antialias(rng, in_hw, out_hw):
    from speechdrivestemplates_tpu.ops.resize import interpolate_bilinear
    from speechdrivestemplates_tpu_torch.ops import resize as tres

    x = rng.randn(2, *in_hw, 4).astype(np.float32)  # JAX layout (B, H, W, C)
    ref = np.asarray(interpolate_bilinear(jnp.asarray(x), out_hw))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tres.interpolate_bilinear(xt, out_hw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # the H squeeze 5 -> 1 is where an antialiasing resize would diverge
    torch_ref = F.interpolate(xt, size=out_hw, mode="bilinear", align_corners=False,
                              antialias=False)
    np.testing.assert_allclose(got, torch_ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("downsample,leaky", [(False, True), (True, True), (False, False)])
def test_conv_norm_relu_1d_matches_jax(rng, downsample, leaky):
    """IN-1d keeps the reference's quirk: a norm over channels at each t."""
    from speechdrivestemplates_tpu.models.blocks import ConvNormRelu as JCNR
    from speechdrivestemplates_tpu_torch.models.blocks import ConvNormRelu

    x = rng.randn(2, 16, 12).astype(np.float32)  # JAX layout (B, T, C)
    jm = JCNR(conv_type="1d", out_channels=24, downsample=downsample, norm="IN",
              leaky=leaky)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), False)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    tm = ConvNormRelu("1d", 12, 24, downsample=downsample, leaky=leaky)
    kernel = np.asarray(variables["params"]["conv"]["kernel"])  # (W, I, O)
    tm.conv.weight.data = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1, 0)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_get_final_results_matches_jax(rng):
    from speechdrivestemplates_tpu.ops import pose as jpose
    from speechdrivestemplates_tpu_torch.ops import pose as tpose

    poses = rng.randn(3, 8, 2, 121).astype(np.float32)
    mean = rng.randn(3, 242).astype(np.float32)
    std = (np.abs(rng.randn(3, 242)) + 0.5).astype(np.float32)
    scale = (rng.rand(3) + 0.5).astype(np.float32)
    for hierarchical in (True, False):
        ref = jpose.get_final_results(poses, mean, std, scale, hierarchical)
        got = tpose.get_final_results(*(torch.from_numpy(a) for a in
                                        (poses, mean, std, scale)), hierarchical)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tpose._build_reroot_tables()[0],
                                  jpose._build_reroot_tables()[0])


def test_speaker_stats_equal_jax():
    from speechdrivestemplates_tpu.datasets import speakers_stat as jstat
    from speechdrivestemplates_tpu_torch.datasets import speakers_stat as tstat

    for parted in (True, False):
        speakers = tstat.available_speakers(parted)
        assert speakers == jstat.available_speakers(parted) and "oliver" in speakers
        for spk in speakers:
            a, b = tstat.get_speaker_stat(spk, 121, parted), jstat.get_speaker_stat(
                spk, 121, parted)
            for k in ("mean", "std", "scale_factor"):
                np.testing.assert_array_equal(a[k], b[k])
