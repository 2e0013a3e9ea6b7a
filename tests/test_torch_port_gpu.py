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


# tiles of up to 128 frames run over the flattened (b, t) axis: at T = 2 (L = 257,
# 300) a tile spans many samples, at T = 101 and 427 the batches below make tiles
# cross sample boundaries
@pytest.mark.parametrize("dynamic_range_db", [0, 60])
@pytest.mark.parametrize("shape", [(1, 257), (7, 257), (1, 300), (3, 300), (3, 16000),
                                   (9, 16000), (5, 68267), (2, 68267), (32, 68266)])
def test_mel_kernel_matches_plain(cuda, shape, dynamic_range_db):
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import mel as M

    audio = _randn(np.random.RandomState(0), *shape, scale=0.1)
    if dynamic_range_db:  # a loud and a quiet half, 60 dB apart in power
        audio[:, shape[1] // 2:] *= 10.0 ** (-dynamic_range_db / 20.0)
    before = kernels.LAUNCHES["mel"]
    got = M.mel_spectrogram(audio)
    assert kernels.LAUNCHES["mel"] == before + 1
    ref = M.mel_spectrogram_plain(audio)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)
    # the quiet half sits far below atol: hold the frames whose window (samples
    # 160 t - 200 .. 160 t + 199) lies wholly inside it relatively, on the bins
    # above 1e-3 of their largest (there are none at L = 257, 300)
    t_quiet = -(-(shape[1] // 2 + 200) // M.HOP_LENGTH)
    q = ref[..., t_quiet:]
    if dynamic_range_db and q.numel():
        sel = q > 1e-3 * q.max()
        torch.testing.assert_close(got[..., t_quiet:][sel], q[sel], rtol=1e-3, atol=0.0)


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


@pytest.mark.parametrize("width", [2, 35, 213, 427, 428])
def test_stem_tail_kernel_bf16_matches_plain_bf16(cuda, width):
    """B2 alone in bf16 (bf16 y2 and y3 inside) against the plain tail in bf16,
    on one bf16 conv1 activation; the bf16 quantile gate and a few bf16 ulps of
    the O(1) post-norm values at most."""
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1
    from speechdrivestemplates_tpu_torch.ops import stem as S

    rng = np.random.RandomState(width)
    mel = _randn(rng, 3, 80, width)
    w1, w2, w3 = (_randn(rng, 64, 1, 3, 3, scale=0.2), _randn(rng, 64, 64, 4, 4, scale=0.05),
                  _randn(rng, 128, 64, 3, 3, scale=0.05))
    y1 = C1.conv1_in_plain(mel, w1, 0.2, torch.bfloat16)
    got = S.stem_tail_kernel(y1, w2, w3, 0.2, torch.bfloat16)
    ref = S.stem_tail_plain(y1, w2, w3, 0.2, torch.bfloat16)
    assert got.shape == ref.shape == (3, 40, S.stem_dims(width)[1], 128)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs()
    assert torch.quantile(err.flatten(), 0.99) < 0.05 and err.mean() < 0.02
    assert err.max() < 0.1


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


# 600: the stats kernel stages the plane in two passes (512 columns each); 2100: the
# apply pass takes two column blocks (2048 each)
@pytest.mark.parametrize("width", [2, 3, 37, 427, 428, 600, 2100])
@pytest.mark.parametrize("slope", [0.2, 0.0])
def test_conv1_kernel_matches_plain(cuda, width, slope):
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1

    rng = np.random.RandomState(width)
    mel = _randn(rng, 2, 80, width)
    w1 = _randn(rng, 64, 1, 3, 3, scale=0.2)
    ref = C1.conv1_in_plain(mel, w1, slope, torch.float32)
    got = C1.fused_conv1_in(mel, w1, slope, torch.float32)
    assert got.shape == ref.shape == (2, C1.ROWS, width, 64)
    assert not got[:, 0].any() and not got[:, -1].any()
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    got16 = C1.fused_conv1_in(mel, w1, slope, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert not got16[:, 0].any() and not got16[:, -1].any()
    assert ((got16.float() - ref).abs().mean() / ref.abs().mean()) < 2e-2


@pytest.mark.parametrize("width", [2, 3, 37, 427, 428])
@pytest.mark.parametrize("kind", ["power", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1_kernel_matches_plain_on_mel_like_inputs(cuda, width, kind, dtype):
    """A power-like mel (nonnegative, heavy-tailed) and one at a large constant
    offset, where fp32 moments E[y^2] - E[y]^2 would lose digits: the kernel's
    fp64 Gram statistics and folded taps hold the fp32 gate; bf16 is a cast of
    that result. One launch per call."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1

    rng = np.random.RandomState(width)
    if kind == "power":
        mel = rng.standard_exponential((2, 80, width)) * rng.standard_exponential((2, 80, 1)) ** 2 * 3
    else:
        mel = 100.0 + rng.randn(2, 80, width)
    mel = torch.from_numpy(mel.astype(np.float32)).to(cuda)
    w1 = _randn(rng, 64, 1, 3, 3, scale=0.2)
    ref = C1.conv1_in_plain(mel, w1, 0.2, torch.float32)
    before = kernels.LAUNCHES["conv1"]
    got = C1.fused_conv1_in(mel, w1, 0.2, dtype)
    assert kernels.LAUNCHES["conv1"] == before + 1
    assert got.shape == ref.shape == (2, C1.ROWS, width, 64) and got.dtype == dtype
    assert not got[:, 0].any() and not got[:, -1].any()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    else:
        assert ((got.float() - ref).abs().mean() / ref.abs().mean()) < 2e-2


@pytest.mark.parametrize("mode", ["aligned", "subtile"])
@pytest.mark.parametrize("c, m, m_out", [(128, 4480, 4032), (64, 4480, 4032), (64, 300, 250),
                                         (128, 137, 129)])
def test_shift_probe_kernel_matches_plain(cuda, mode, c, m, m_out):
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import shift_probe as SP

    rng = np.random.RandomState(c + m)
    x = _randn(rng, 3, m, c, scale=0.1).to(torch.bfloat16)
    w = _randn(rng, 9, c, c, scale=0.05).to(torch.bfloat16)
    before = kernels.LAUNCHES["shift_probe"]
    got = SP.shift_taps(x, w, m_out, mode)
    assert kernels.LAUNCHES["shift_probe"] == before + 1
    ref = SP.shift_taps_plain(x, w, m_out, mode)
    assert got.shape == ref.shape == (3, m_out, c) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2, atol=1e-3)


def test_stem_launches_conv1_then_stem_once_each(cuda):
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import stem as S

    rng = np.random.RandomState(2)
    mel = _randn(rng, 2, 80, 64)
    w = (_randn(rng, 64, 1, 3, 3, scale=0.2), _randn(rng, 64, 64, 4, 4, scale=0.05),
         _randn(rng, 128, 64, 3, 3, scale=0.05))
    for i in range(1, 3):
        before = dict(kernels.LAUNCHES)
        S.audio_encoder_stem(mel, *w, dtype=torch.bfloat16)
        for name in ("conv1", "stem"):
            assert kernels.LAUNCHES[name] == before.get(name, 0) + 1, (i, name)


def test_kernel_wrappers_raise_on_cuda_tensors_that_require_grad(cuda):
    """A kernel's output carries no grad_fn: each wrapper raises rather than
    drop a gradient, and launches nothing."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops import shift_probe as SP
    from speechdrivestemplates_tpu_torch.ops import stem as S

    rng = np.random.RandomState(4)
    w1 = _randn(rng, 64, 1, 3, 3, scale=0.2).requires_grad_()
    w2 = _randn(rng, 64, 64, 4, 4, scale=0.05).requires_grad_()
    w3 = _randn(rng, 128, 64, 3, 3, scale=0.05)
    calls = [lambda: M.mel_spectrogram(_randn(rng, 2, 16000).requires_grad_()),
             lambda: C1.fused_conv1_in(_randn(rng, 2, 80, 64), w1),
             lambda: S.stem_tail_kernel(torch.zeros(2, 82, 64, 64, device="cuda"), w2, w3),
             lambda: S.audio_encoder_stem(_randn(rng, 2, 80, 64), w1, w2, w3),
             lambda: SP.shift_taps(_randn(rng, 2, 300, 64).to(torch.bfloat16).requires_grad_(),
                                   _randn(rng, 9, 64, 64).to(torch.bfloat16), 250)]
    before = dict(kernels.LAUNCHES)
    for call in calls:
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
    assert dict(kernels.LAUNCHES) == before
    with torch.no_grad():
        out = C1.fused_conv1_in(_randn(rng, 2, 80, 64), w1)
    assert out.grad_fn is None and kernels.LAUNCHES["conv1"] == before.get("conv1", 0) + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generator_train_mode_runs_the_plain_stem_with_gradients(cuda, dtype):
    """Train mode launches no conv1 or stem kernel and the stem's weights get
    gradients (cuDNN under autograd); eval mode under no_grad launches each
    kernel once."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model

    precision = "bf16" if dtype == torch.bfloat16 else "fp32"
    model = build_model("SequenceGeneratorCNN", sdt_bp(precision=precision), device="cuda")
    rng = np.random.RandomState(5)
    mel, code = _randn(rng, 2, 80, 107), _randn(rng, 2, 32)
    before = dict(kernels.LAUNCHES)
    model.train()
    model(mel, 32, code).float().square().mean().backward()
    torch.cuda.synchronize()
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("conv1", "stem")} == \
        {"conv1": 0, "stem": 0}
    for layer in model.audio_encoder.layers()[:3]:
        g = layer.conv.weight.grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    model.eval()
    with torch.no_grad():
        model(mel, 32, code)
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("conv1", "stem")} == \
        {"conv1": 1, "stem": 1}


def test_train_step_on_the_card(cuda):
    """One SDT-BP bf16 train step on a device-resident batch: the mel kernel
    once, no stem kernel, finite losses, a KL skipped at the zero bank."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                     train_step)
    from speechdrivestemplates_tpu_torch.profile_train import train_batch

    cfg = sdt_bp()
    state = Voice2PoseTrainState(cfg, 8, "cuda")
    batch = train_batch(cfg, 4, 8, "cuda")
    before = dict(kernels.LAUNCHES)
    losses, results = train_step(state, batch)
    torch.cuda.synchronize()
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("mel", "conv1", "stem")} == \
        {"mel": 1, "conv1": 0, "stem": 0}
    assert all(torch.isfinite(v) for v in losses.values())
    assert losses["G_clipcode_kl_loss"].item() == 0.0
    assert results["poses_pred_batch"].shape == (4, 64, 2, 121)
    assert state.clips_code.detach()[:4].abs().sum() > 0
