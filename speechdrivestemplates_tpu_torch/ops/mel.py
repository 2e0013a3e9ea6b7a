"""Mel-spectrogram frontend: torchaudio ``MelSpectrogram(n_fft=512, win_length=400,
hop_length=160, f_min=55, f_max=7500, n_mels=80)`` semantics, as the reference
uses it: periodic Hann(400) zero-padded to 512, center=True with reflect
padding, power spectrum, HTK mel filterbank without normalization.

``mel_spectrogram`` is the entry: on a CUDA tensor it launches the fused
STFT+mel kernel (``csrc/mel.cu``: the DFT and the mel projection on the tensor
cores as three bf16 passes, hi*hi + hi*lo + lo*hi, reflect padding by index)
and raises if it cannot; on a CPU tensor it runs ``mel_spectrogram_plain``, the
same function in plain PyTorch (the JAX package's ``impl='dft'`` path:
framing, two real-DFT matmuls, power, mel matmul).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

N_FFT = 512
WIN_LENGTH = 400
HOP_LENGTH = 160
N_MELS = 80
F_MIN = 55.0
F_MAX = 7500.0
SAMPLE_RATE = 16000
K_USED = 256  # DFT bins the kernel keeps: every mel filter ends by bin 239


def _hz_to_mel(f):
    """HTK mel scale (torchaudio mel_scale='htk')."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float):
    """Triangular mel filterbank, (n_freqs, n_mels), torchaudio melscale_fbanks
    semantics (norm=None, htk scale)."""
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    m_min, m_max = _hz_to_mel(f_min), _hz_to_mel(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _window_np(win_length: int, n_fft: int):
    """Periodic Hann of win_length, zero-padded symmetrically to n_fft
    (torch.stft pads the window with (n_fft - win_length) // 2 on the left)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[left:left + win_length] = w.astype(np.float32)
    return out


@functools.lru_cache(maxsize=4)
def _dft_matrices_np(n_fft: int):
    """Real-input DFT as two matmuls: frames @ C -> Re, frames @ S -> -Im.
    C, S: (n_fft, n_freqs)."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _kernel_tables_np():
    """The kernel's constant operands.

    ``cs``: (WIN_LENGTH, 2*K_USED) windowed DFT basis over the window's support
    only (frame samples 56..455; the zero-padded ends contribute nothing):
    ``cs[k, j] = win[56+k] * cos(2 pi (56+k) j / 512)`` for j < 256 and the sine
    for j >= 256, computed in float64. ``fb``: the filterbank's first K_USED rows.
    """
    fb = _mel_filterbank_np(SAMPLE_RATE, N_FFT, N_MELS, F_MIN, F_MAX)
    # bins >= K_USED carry no mel weight (f_max < Nyquist): trimming them is exact
    assert not fb[K_USED:].any(), "mel filterbank extends past K_USED bins"
    left = (N_FFT - WIN_LENGTH) // 2
    n = np.arange(left, left + WIN_LENGTH, dtype=np.float64)[:, None]
    k = np.arange(K_USED, dtype=np.float64)[None, :]
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * (n - left) / WIN_LENGTH)
    ang = 2.0 * np.pi * n * k / N_FFT
    cs = np.concatenate([win * np.cos(ang), win * np.sin(ang)], axis=1)
    return cs.astype(np.float32), np.ascontiguousarray(fb[:K_USED])


def split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi), both rounded
    to nearest even: hi + lo carries x to about 2^-16 relative."""
    hi = x.float().to(torch.bfloat16)
    return hi, (x.float() - hi.float()).to(torch.bfloat16)


@functools.lru_cache(maxsize=8)
def _kernel_tables(device: torch.device):
    """The kernel's constant operands split once: (cs_hi, cs_lo, fb_hi, fb_lo)."""
    cs, fb = (torch.from_numpy(a) for a in _kernel_tables_np())
    return tuple(t.contiguous().to(device) for t in (*split_bf16(cs), *split_bf16(fb)))


def mel_spectrogram_plain(audio: torch.Tensor) -> torch.Tensor:
    """(..., L) float32 -> (..., 80, L // 160 + 1) float32, plain PyTorch."""
    lead, L = audio.shape[:-1], audio.shape[-1]
    x = audio.reshape(-1, 1, L).float()
    pad = N_FFT // 2
    x = F.pad(x, (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)  # (B, T, n_fft)
    dev = audio.device
    window = torch.from_numpy(_window_np(WIN_LENGTH, N_FFT)).to(dev)
    cos_m, sin_m = (torch.from_numpy(m).to(dev) for m in _dft_matrices_np(N_FFT))
    fb = torch.from_numpy(_mel_filterbank_np(SAMPLE_RATE, N_FFT, N_MELS, F_MIN,
                                             F_MAX)).to(dev)
    frames = frames * window
    re = frames @ cos_m
    im = frames @ sin_m
    mel = (re * re + im * im) @ fb  # (B, T, n_mels)
    return mel.transpose(-1, -2).reshape(*lead, N_MELS, mel.shape[1])


def mel_spectrogram_kernel(audio: torch.Tensor) -> torch.Tensor:
    """The fused STFT+mel CUDA kernel; same contract as the plain version.
    Forward-only: raises for audio that requires grad under grad mode."""
    kernels.refuse_grad("the mel kernel", audio)
    if audio.device.type != "cuda":
        raise ValueError("mel kernel takes a CUDA tensor")
    if audio.dtype != torch.float32:
        raise TypeError(f"mel kernel takes float32 audio, got {audio.dtype}")
    lead, L = audio.shape[:-1], audio.shape[-1]
    if L <= N_FFT // 2:
        raise ValueError(f"audio of {L} samples is too short for reflect padding")
    x = audio.reshape(-1, L).contiguous()  # unpadded: the kernel mirrors by index
    B = x.shape[0]
    T = L // HOP_LENGTH + 1
    tables = _kernel_tables(audio.device)
    out = torch.empty((B, N_MELS, T), dtype=torch.float32, device=audio.device)
    lib = kernels.library("mel")
    err = lib.sdt_mel_forward(x.data_ptr(), *(t.data_ptr() for t in tables),
                              out.data_ptr(), B, L, T, kernels.current_stream(audio.device))
    kernels.LAUNCHES["mel"] += 1
    kernels.check(err, "sdt_mel_forward")
    return out.reshape(*lead, N_MELS, T)


def mel_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """Power mel spectrogram of a waveform batch: (..., L) -> (..., 80, T) with
    T = L // 160 + 1. The kernel on CUDA, the plain version on the CPU."""
    if audio.device.type == "cpu":
        return mel_spectrogram_plain(audio)
    return mel_spectrogram_kernel(audio)

