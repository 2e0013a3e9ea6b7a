"""The power mel spectrogram of torchaudio's ``MelSpectrogram(sample_rate=16000,
n_fft=512, win_length=400, hop_length=160, f_min=55, f_max=7500, n_mels=80)``,
as the reference repository computes it: a periodic Hann window of 400
samples centred in 512, reflect padding (``center=True``), |STFT|^2, and the
HTK triangular filterbank without normalization."""

import numpy as np
import torch

SAMPLE_RATE, N_FFT, WIN_LENGTH, HOP_LENGTH = 16000, 512, 400, 160
N_MELS, F_MIN, F_MAX = 80, 55.0, 7500.0


def filterbank() -> np.ndarray:
    """(N_FFT // 2 + 1, N_MELS) HTK triangles, float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    f_pts = 700.0 * (10.0 ** (np.linspace(hz_to_mel(F_MIN), hz_to_mel(F_MAX), N_MELS + 2)
                              / 2595.0) - 1.0)
    diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def mel_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """(B, L) float32 audio -> (B, 80, L // 160 + 1) float32."""
    window = torch.hann_window(WIN_LENGTH, periodic=True, dtype=torch.float32,
                               device=audio.device)
    spec = torch.stft(audio.float(), N_FFT, HOP_LENGTH, WIN_LENGTH, window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2  # (B, 257, T)
    fb = torch.from_numpy(filterbank()).to(audio.device, torch.float32)
    return torch.einsum("bft,fm->bmt", power, fb)
