"""The mel kernel's arithmetic (``csrc/mel.cu``), emulated in plain PyTorch on
the CPU, against the JAX package's ``mel_spectrogram(impl='dft')``.

The kernel splits each fp32 operand x into bf16 halves, hi = bf16(x) and
lo = bf16(x - hi), and forms a product as hi*hi + hi*lo + lo*hi with fp32
accumulation, for the DFT (frames x windowed table) and for the mel projection
(power x filterbank). It reads the unpadded audio and mirrors indices at both
ends. The emulation below does the same steps in the same order; products of
two bf16 values are exact in fp32, so only the summation order differs from the
tensor cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu.ops import mel as jmel
from speechdrivestemplates_tpu_torch.ops import mel as tmel


def _dot3(a_hi, a_lo, b_hi, b_lo):
    f = torch.float32
    return (a_hi.to(f) @ b_hi.to(f)) + (a_hi.to(f) @ b_lo.to(f)) + (a_lo.to(f) @ b_hi.to(f))


def _mel_with(audio: np.ndarray, dft, project) -> np.ndarray:
    """(B, L) -> (B, 80, T) through the kernel's indexing, with ``dft`` taking
    the (B*T, 400) frames to [re | im] and ``project`` the power to mel."""
    x = torch.from_numpy(audio)
    B, L = x.shape
    T = L // tmel.HOP_LENGTH + 1
    # tap k of frame t reads sample t*160 - 200 + k of the unpadded audio,
    # mirrored at both ends (reflect padding by index)
    idx = (torch.arange(T)[:, None] * tmel.HOP_LENGTH - 200
           + torch.arange(tmel.WIN_LENGTH)[None, :])
    idx = idx.abs()
    idx = torch.where(idx >= L, 2 * (L - 1) - idx, idx)
    frames = x[:, idx].reshape(B * T, tmel.WIN_LENGTH)
    reim = dft(frames)  # (B*T, 512)
    k = tmel.K_USED
    power = reim[:, :k] ** 2 + reim[:, k:] ** 2
    mel = project(power)  # (B*T, 80)
    return mel.reshape(B, T, tmel.N_MELS).transpose(1, 2).numpy()


def emulate_kernel(audio: np.ndarray) -> np.ndarray:
    """(B, L) -> (B, 80, T) with the kernel's operands, split and indexing."""
    cs_hi, cs_lo, fb_hi, fb_lo = tmel._kernel_tables(torch.device("cpu"))
    return _mel_with(audio, lambda f: _dot3(*tmel.split_bf16(f), cs_hi, cs_lo),
                     lambda p: _dot3(*tmel.split_bf16(p), fb_hi, fb_lo))


def test_host_split_tables_reconstruct_to_2_pow_minus_16():
    cs, fb = tmel._kernel_tables_np()
    cs_hi, cs_lo, fb_hi, fb_lo = tmel._kernel_tables(torch.device("cpu"))
    for full, hi, lo in ((cs, cs_hi, cs_lo), (fb, fb_hi, fb_lo)):
        assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == full.shape
        err = np.abs(hi.float().numpy() + lo.float().numpy() - full)
        assert (err <= 2.0 ** -16 * np.abs(full)).all(), err.max()
        # the low half is needed: the high half alone is off by up to 2^-9
        assert np.abs(hi.float().numpy() - full).max() > 2.0 ** -16 * np.abs(full).max()


def _audio(rng, shape, dynamic_range_db):
    audio = (rng.randn(*shape) * 0.1).astype(np.float32)
    if dynamic_range_db:
        # loud first half, quiet second half, 60 dB (1000x in amplitude) apart
        audio[:, shape[1] // 2:] *= np.float32(10.0 ** (-dynamic_range_db / 20.0))
    return audio


@pytest.mark.parametrize("dynamic_range_db", [0, 60])
@pytest.mark.parametrize("shape", [(2, 16000), (1, 68267), (3, 257)])
def test_split_arithmetic_matches_jax_dft(rng, shape, dynamic_range_db):
    audio = _audio(rng, shape, dynamic_range_db)
    ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(audio), impl="dft"))
    got = emulate_kernel(audio)
    assert got.shape == ref.shape == (shape[0], 80, shape[1] // 160 + 1)
    # the gate of tests/test_mel_pallas.py
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_split_arithmetic_keeps_the_quiet_half(rng):
    """At 60 dB the quiet half's mel values sit far below atol; hold them to
    the reference relatively too, where they carry energy."""
    audio = _audio(rng, (1, 32000), 60)
    ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(audio), impl="dft"))
    got = emulate_kernel(audio)
    quiet = slice(110, None)  # frames whose window lies in the quiet half
    assert ref[..., quiet].max() < 1e-4 * ref.max()
    sel = ref[..., quiet] > 1e-3 * ref[..., quiet].max()
    np.testing.assert_allclose(got[..., quiet][sel], ref[..., quiet][sel], rtol=1e-3)


def _tf32(x):
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds), held in fp32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _lo(x):
    return _bf16(x.float() - _bf16(x))


# tensor-core routes that cost at most two thirds of the kernel's three bf16
# passes; products of two bf16 or two TF32 values are exact in fp32
CHEAPER_ROUTES = {
    "one tf32 pass": lambda a, b: _tf32(a) @ _tf32(b),
    "one bf16 pass": lambda a, b: _bf16(a) @ _bf16(b),
    "two bf16 passes, table split": lambda a, b: _bf16(a) @ _bf16(b) + _bf16(a) @ _lo(b),
    "two bf16 passes, data split": lambda a, b: _bf16(a) @ _bf16(b) + _lo(a) @ _bf16(b),
}


@pytest.mark.parametrize("route", sorted(CHEAPER_ROUTES))
def test_cheaper_tensor_core_routes_miss_the_gate(route):
    """Each cheaper route misses the rtol 1e-3 / atol 1e-4 gate on a normal
    input, so the kernel's bound counts three bf16 passes."""
    audio = _audio(np.random.RandomState(0), (2, 68267), 0)
    ref = np.asarray(jmel.mel_spectrogram(jnp.asarray(audio), impl="dft"))
    np.testing.assert_allclose(emulate_kernel(audio), ref, rtol=1e-3, atol=1e-4)
    cs, fb = (torch.from_numpy(a) for a in tmel._kernel_tables_np())
    dot = CHEAPER_ROUTES[route]
    got = _mel_with(audio, lambda f: dot(f, cs), lambda p: dot(p, fb))
    excess = np.abs(got - ref) - (1e-3 * np.abs(ref) + 1e-4)
    assert excess.max() > 0, f"{route} meets the gate: the bound should count it"
