"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present. On a machine with a
card (and without JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, device="cuda"):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape", [(1, 300), (3, 16000), (5, 68267)])
def test_mel_kernel_matches_plain(cuda, shape):
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import mel as M

    audio = _randn(np.random.RandomState(0), *shape, scale=0.1)
    before = kernels.LAUNCHES["mel"]
    got = M.mel_spectrogram(audio)
    assert kernels.LAUNCHES["mel"] == before + 1
    ref = M.mel_spectrogram_plain(audio)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("width", [2, 35, 36, 130, 427, 428])
@pytest.mark.parametrize("slope", [0.2, 0.0])
def test_stem_kernel_fp32_matches_plain(cuda, width, slope):
    from speechdrivestemplates_tpu_torch.ops import stem as S

    rng = np.random.RandomState(width)
    mel = _randn(rng, 2, 80, width)
    w = (_randn(rng, 64, 1, 3, 3, scale=0.2), _randn(rng, 64, 64, 4, 4, scale=0.05),
         _randn(rng, 128, 64, 3, 3, scale=0.05))
    got = S.audio_encoder_stem(mel, *w, slope=slope, dtype=torch.float32)
    ref = S.stem_plain(mel, *w, slope=slope, dtype=torch.float32)
    assert got.shape == ref.shape == (2, 40, S.stem_dims(width)[1], 128)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def test_stem_kernel_bf16_within_quantile_gate(cuda):
    from speechdrivestemplates_tpu_torch.ops import stem as S

    rng = np.random.RandomState(1)
    mel = _randn(rng, 4, 80, 427)
    w = (_randn(rng, 64, 1, 3, 3, scale=0.2), _randn(rng, 64, 64, 4, 4, scale=0.05),
         _randn(rng, 128, 64, 3, 3, scale=0.05))
    got = S.audio_encoder_stem(mel, *w, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = (got.float() - S.stem_plain(mel, *w, dtype=torch.float32)).abs()
    assert torch.quantile(err.flatten()[:4_000_000], 0.99) < 0.05 and err.mean() < 0.02
