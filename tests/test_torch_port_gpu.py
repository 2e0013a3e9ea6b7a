"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where no CUDA device is present. On a machine with a
card (and without JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py
"""

import collections

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
                                   (9, 16000), (5, 68267), (2, 68267), (32, 68266),
                                   (1, 68266), (1, 164266), (1, 384000)])
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


@pytest.mark.parametrize("width", [2, 35, 36, 130, 427, 428, 1027, 1201, 2401])
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


@pytest.mark.parametrize("width", [2, 35, 213, 427, 428, 1027, 1201, 2401])
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
    # torch.quantile takes at most 2^24 values: every k-th of the wide demo widths'
    q99 = torch.quantile(err.flatten()[:: max(1, err.numel() // 4_000_000)], 0.99)
    assert q99 < 0.05 and err.mean() < 0.02
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
# apply pass takes two column blocks (2048 each); 1027 and 2401: a 10.3 s and a 24 s
# demo clip's mel
@pytest.mark.parametrize("width", [2, 3, 37, 427, 428, 600, 1027, 2100, 2401])
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
    from speechdrivestemplates_tpu_torch.ops import in_act as IA
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
                                   _randn(rng, 9, 64, 64).to(torch.bfloat16), 250),
             lambda: IA.in_act_kernel(_randn(rng, 2, 256, 8).requires_grad_(), 0.2)]
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
    """Train mode launches no conv1, stem or in_act kernel and the stem's
    weights get gradients (cuDNN under autograd); eval mode under no_grad
    launches conv1 and the stem once each and in_act once for each of the 21
    IN layers after the stem."""
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
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("conv1", "stem", "in_act")} == \
        {"conv1": 0, "stem": 0, "in_act": 0}
    for layer in model.audio_encoder.layers()[:3]:
        g = layer.conv.weight.grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
    model.eval()
    with torch.no_grad():
        model(mel, 32, code)
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("conv1", "stem", "in_act")} == \
        {"conv1": 1, "stem": 1, "in_act": 21}


def test_train_step_on_the_card(cuda):
    """One SDT-BP bf16 train step on a device-resident batch: the mel kernel
    once, no stem kernel, finite losses, a KL skipped at the zero bank."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                     train_step)
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch

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


@pytest.mark.parametrize("batch", [32, 3])
def test_eval_step_launches_mel_conv1_stem_once_each(cuda, batch):
    """The SDT-BP bf16 eval step (a test or validation batch, B = 32, and the
    ragged last batch of 131 dev clips, B = 3): the mel, conv1 and stem
    kernels once each, finite losses and latents, and the state back in train
    mode."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                     eval_step)
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch

    cfg = sdt_bp()
    state = Voice2PoseTrainState(cfg, 8, "cuda")
    b = train_batch(cfg, batch, 8, "cuda")
    assert b["audio"].shape == (batch, 68266)
    before = dict(kernels.LAUNCHES)
    losses, results = eval_step(state, b)
    torch.cuda.synchronize()
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("mel", "conv1", "stem")} == \
        {"mel": 1, "conv1": 1, "stem": 1}
    assert all(torch.isfinite(losses[k]) for k in ("G_reg_loss", "L2_dist", "lip_sync_error_n"))
    for k in ("mu_pred", "logvar_pred", "mu_gt", "logvar_gt"):
        assert results[k].shape == (batch, 32) and torch.isfinite(results[k]).all(), k
    assert state.generator.training and state.pose_encoder.training


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernels_match_plain_at_the_ragged_eval_batch(cuda, dtype):
    """B3 then B2 (``stem_kernel``) against the plain stem at the ragged last
    eval batch's shape, (3, 80, 427): fp32 at the tight gate, bf16 within the
    quantile gate of the serving shape."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import stem as S

    rng = np.random.RandomState(7)
    mel = _randn(rng, 3, 80, 427)
    w = (_randn(rng, 64, 1, 3, 3, scale=0.2), _randn(rng, 64, 64, 4, 4, scale=0.05),
         _randn(rng, 128, 64, 3, 3, scale=0.05))
    before = dict(kernels.LAUNCHES)
    got = S.stem_kernel(mel, *w, 0.2, dtype)
    assert {n: kernels.LAUNCHES[n] - before.get(n, 0) for n in ("conv1", "stem")} == \
        {"conv1": 1, "stem": 1}
    ref = S.stem_plain(mel, *w, 0.2, torch.float32)
    assert got.shape == ref.shape == (3, *S.stem_dims(427), 128)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)
    else:
        err = (got.float() - ref).abs().flatten()
        assert torch.quantile(err, 0.99) < 0.05 and err.mean() < 0.02


def _device_cache(cfg, n, pipeline):
    """A device-resident train set of ``n`` random clips in the loader's form,
    the keys ``pipeline``'s pipeline stages (those the batch has)."""
    from speechdrivestemplates_tpu_torch.pipelines.trainer import PIPELINES
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch

    batch = train_batch(cfg, n, n, "cuda", seed=3)
    return {k: batch[k] for k in PIPELINES[cfg.PIPELINE_TYPE].device_keys if k in batch}


def _graph_cfg(pipeline, *opts):
    """``pipeline``: 'Voice2Pose' (SDT-BP), 's2g' or 'Pose2Pose'."""
    from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose, s2g, sdt_bp

    cfg = {"Voice2Pose": sdt_bp, "s2g": s2g, "Pose2Pose": pose2pose}[pipeline]()
    return apply_overrides(cfg, ["TRAIN.BATCH_SIZE", "2", "TRAIN.STEPS_PER_DISPATCH", "3",
                                 *opts])


def _run_chunks(pipeline, cfg, cache, chunks, graphed, between=None):
    """A capturable train state through ``chunks`` of cache rows, graphed or
    eagerly; ``between(state)`` runs after each chunk. Returns the state and
    the stacked loss rows."""
    from speechdrivestemplates_tpu_torch.pipelines.graphed import ChunkRunner
    from speechdrivestemplates_tpu_torch.pipelines.trainer import PIPELINES

    p = PIPELINES[cfg.PIPELINE_TYPE]
    state = p.state(cfg, cache["clip_index"].shape[0], "cuda", capturable=True)
    runner = ChunkRunner(state, p.train_step, cache, graphed=graphed)
    rows = []
    for c in chunks:
        rows.append(runner.run(torch.tensor(c, device="cuda")))
        if between is not None:
            between(state)
    torch.cuda.synchronize()
    return state, torch.cat(rows), runner


# warm-up chunk (eager), a K = 3 chunk (captured, replayed), again (replayed),
# a remainder of 2 (captured, replayed)
_CHUNKS = [[[0, 1], [2, 3], [4, 5]], [[6, 7], [1, 0], [3, 2]], [[5, 4], [7, 6], [0, 2]],
           [[1, 3], [4, 6]]]


@pytest.mark.parametrize("pipeline", ["Voice2Pose", "s2g", "Pose2Pose"])
def test_graphed_chunks_match_eager_steps(cuda, pipeline):
    """K = 3 steps a CUDA graph against the same steps run eagerly under the
    same capturable Adam, on the same cache rows: the loss rows, every weight,
    bank and BN statistic (s2g's discriminator's, moved three times a step,
    included), the Adams' moments and the noise generator's offset agree bit
    for bit (cuDNN deterministic on both sides). For Voice2Pose and s2g the
    mel kernel ran once per step: eager launches, then captured ones counted
    apart from the replays that ran them; s2g ran neither conv1 nor the stem."""
    from speechdrivestemplates_tpu_torch import kernels

    torch.backends.cudnn.deterministic = True
    try:
        cfg = _graph_cfg(pipeline)
        cache = _device_cache(cfg, 8, pipeline)
        kernels.reset_launch_counts()
        g_state, g_rows, runner = _run_chunks(pipeline, cfg, cache, _CHUNKS, graphed=True)
        counts = (dict(kernels.LAUNCHES), dict(kernels.CAPTURED), dict(kernels.REPLAYED),
                  dict(kernels.executions()))
        e_state, e_rows, _ = _run_chunks(pipeline, cfg, cache, _CHUNKS, graphed=False)
    finally:
        torch.backends.cudnn.deterministic = False
    steps = sum(len(c) for c in _CHUNKS)
    assert sorted(runner.graphs) == [2, 3]
    assert g_rows.shape == (steps, len(runner.names)) and torch.isfinite(g_rows).all()
    assert torch.equal(g_rows, e_rows), (g_rows - e_rows).abs().max()
    assert g_state.step == e_state.step == steps
    g_sd = g_state.state_dict()
    for k, v in e_state.state_dict().items():
        assert torch.equal(g_sd[k], v), k
    for go, eo in zip(g_state.optimizers(), e_state.optimizers()):
        for p_g, p_e in zip(go.param_groups[0]["params"], eo.param_groups[0]["params"]):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(go.state[p_g][key], eo.state[p_e][key]), key
    assert g_state.rng.get_offset() == e_state.rng.get_offset()
    if pipeline != "Pose2Pose":
        launches, captured, replayed, executed = counts
        assert launches["mel"] == 3 + 3 + 2 and captured["mel"] == 3 + 2
        assert replayed["mel"] == 3 + 3 + 2 and executed["mel"] == steps
        assert set(launches) == {"mel"}
    else:
        assert not counts[0]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_s2g_eval_forward_on_the_card_equals_its_plain_forward(cuda, dtype):
    """s2g's BN generator in eval mode with non-trivial running statistics
    (two train-mode forwards first), through ``build_serving_fn`` on the
    card: the mel kernel once, bn_act once a BN layer (24), conv1 and the stem
    never (their counters stay at 0: the kernels compute InstanceNorm); the
    same weights' forward on the plain mel, with ``plain`` (which keeps BN's
    plain path), agrees within the mel kernel's round-off (rel L2 < 1e-3 in
    fp32, < 2e-2 in bf16) and launches nothing."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import s2g
    from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    cfg = s2g(precision=dtype)
    rng = np.random.RandomState(9)
    model = build_model("SequenceGeneratorCNN", cfg, "cuda").train()
    with torch.no_grad():
        for _ in range(2):
            model(M.mel_spectrogram_plain(_randn(rng, 4, 68266, scale=0.1)), 64, None)
    model.eval()
    sd = model.state_dict()
    fn, has_code = build_serving_fn(cfg, sd, "cuda")
    audio = _randn(rng, 8, 68267, scale=0.1)
    kernels.reset_launch_counts()
    got = fn(audio)
    torch.cuda.synchronize()
    assert not has_code and dict(kernels.LAUNCHES) == {"mel": 1, "bn_act": 24}
    with torch.no_grad():
        pred = model(M.mel_spectrogram_plain(audio), 64, None, plain=True)
    stat = {k: torch.as_tensor(np.repeat(np.asarray(v)[None], 8, 0)).cuda()
            for k, v in get_speaker_stat("oliver", 121, False).items()}
    want = get_final_results(pred, stat["mean"], stat["std"], stat["scale_factor"], False)
    rel = (torch.linalg.norm(got.float() - want.float()) / torch.linalg.norm(want.float())).item()
    assert got.shape == (8, 64, 2, 121) and rel < (1e-3 if dtype == "fp32" else 2e-2), rel
    assert dict(kernels.LAUNCHES) == {"mel": 1, "bn_act": 24}


def test_graph_replays_draw_fresh_pose2pose_noise(cuda):
    """At LR 0 the weights stay put and train-mode BN takes batch statistics,
    so two replays of one graph on the same rows differ only by their
    reparameterization draws: they must differ, and the noise generator's
    offset must advance with each replay as eager steps advance it."""
    cfg = _graph_cfg("Pose2Pose", "TRAIN.LR", "0.0")
    cache = _device_cache(cfg, 8, "Pose2Pose")
    same = [[0, 1], [2, 3], [4, 5]]
    offsets = []
    state, rows, _ = _run_chunks("Pose2Pose", cfg, cache, [same] * 4, graphed=True,
                                 between=lambda s: offsets.append(s.rng.get_offset()))
    first_replay, second_replay = rows[6:9], rows[9:12]
    assert not torch.equal(first_replay, second_replay)
    steps = [b - a for a, b in zip(offsets, offsets[1:])]
    assert steps[0] == steps[1] == steps[2] > 0, offsets


def test_scheduler_moves_the_tensor_lr_that_replays_read(cuda):
    """MultiStepLR at each epoch end (after every chunk here) fills the
    learning-rate tensor the graphs captured, in place (same tensor, same
    address), and the next replays step with the new rate: graphed and eager
    runs with the same epoch ends stay bit-equal, and the rate fell by 10x at
    the milestone."""
    cfg = _graph_cfg("Pose2Pose", "TRAIN.NUM_EPOCHS", "3")  # milestones [-7, 1]
    cache = _device_cache(cfg, 8, "Pose2Pose")
    seen = []

    def epoch_end(state):
        group = state.opt.param_groups[0]
        before = (group["lr"], group["lr"].data_ptr())
        state.end_epoch()
        seen.append(before + (group["lr"], group["lr"].data_ptr(), float(group["lr"])))

    torch.backends.cudnn.deterministic = True
    try:
        g_state, g_rows, _ = _run_chunks("Pose2Pose", cfg, cache, _CHUNKS, True, epoch_end)
        e_state, e_rows, _ = _run_chunks("Pose2Pose", cfg, cache, _CHUNKS, False,
                                         lambda s: s.end_epoch())
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(t0 is t1 and p0 == p1 for t0, p0, t1, p1, _ in seen)
    assert seen[0][4] == pytest.approx(cfg.TRAIN.LR * 0.1, rel=1e-6) == seen[-1][4]
    assert g_state.learning_rates() == e_state.learning_rates()
    assert torch.equal(g_rows, e_rows)
    e_sd = e_state.state_dict()
    for k, v in g_state.state_dict().items():
        assert torch.equal(v, e_sd[k]), k


def test_graph_replay_launch_counts(cuda):
    """A replay runs the kernels its capture recorded: after a warm-up chunk,
    one capture and four replays of K = 3 Voice2Pose steps, LAUNCHES counts
    the host launches (3 eager + 3 recorded), CAPTURED the 3 recorded,
    REPLAYED 3 per replay, and executions() one mel kernel per step."""
    from speechdrivestemplates_tpu_torch import kernels

    cfg = _graph_cfg("Voice2Pose")
    cache = _device_cache(cfg, 8, "Voice2Pose")
    kernels.reset_launch_counts()
    _run_chunks("Voice2Pose", cfg, cache, [_CHUNKS[0]] * 5, graphed=True)
    assert kernels.LAUNCHES["mel"] == 6 and kernels.CAPTURED["mel"] == 3
    assert kernels.REPLAYED["mel"] == 12 and kernels.executions()["mel"] == 15


@pytest.mark.parametrize("saved_capturable", [False, True])
def test_resume_state_loads_across_capturable_modes(cuda, saved_capturable):
    """A resume file written by a run with the plain Adam loads into a
    capturable state (K > 1) and the other way round: the loading state keeps
    its own flags, its learning-rate tensor (same object, filled with the
    saved rate) or float, and its step counts where its policy keeps them;
    the moments are the saved ones, and the next step runs (graphed for the
    capturable state)."""
    from speechdrivestemplates_tpu_torch.pipelines.pose2pose import Pose2PoseTrainState

    cfg = _graph_cfg("Pose2Pose", "TRAIN.NUM_EPOCHS", "3")
    cache = _device_cache(cfg, 8, "Pose2Pose")
    if saved_capturable:
        saved = _run_chunks("Pose2Pose", cfg, cache, _CHUNKS[:2], graphed=True,
                            between=lambda s: s.end_epoch())[0]
    else:
        saved = _run_plain_chunks(cfg, cache)
    sd = saved.train_state_dict()
    live = Pose2PoseTrainState(cfg, 8, "cuda", capturable=not saved_capturable)
    lr_before = live.opt.param_groups[0]["lr"]
    live.load_train_state(sd)
    group = live.opt.param_groups[0]
    assert group["capturable"] is (not saved_capturable)
    assert float(group["lr"]) == pytest.approx(cfg.TRAIN.LR * 0.1, rel=1e-6)
    if not saved_capturable:
        assert group["lr"] is lr_before and isinstance(lr_before, torch.Tensor)
    else:
        assert isinstance(group["lr"], float)
    for p, q in zip(group["params"], saved.opt.param_groups[0]["params"]):
        st, ref = live.opt.state[p], saved.opt.state[q]
        assert st["step"].device.type == ("cuda" if not saved_capturable else "cpu")
        assert torch.equal(st["exp_avg"], ref["exp_avg"]) and float(st["step"]) == 6
    from speechdrivestemplates_tpu_torch.pipelines.graphed import ChunkRunner
    from speechdrivestemplates_tpu_torch.pipelines.pose2pose import train_step

    runner = ChunkRunner(live, train_step, cache, graphed=not saved_capturable)
    for c in _CHUNKS[2:]:
        assert torch.isfinite(runner.run(torch.tensor(c, device="cuda"))).all()


def _run_plain_chunks(cfg, cache):
    """Two chunks of eager steps under the plain Adam, an epoch end after each."""
    from speechdrivestemplates_tpu_torch.pipelines.graphed import ChunkRunner
    from speechdrivestemplates_tpu_torch.pipelines.pose2pose import (Pose2PoseTrainState,
                                                                     train_step)

    state = Pose2PoseTrainState(cfg, 8, "cuda", capturable=False)
    runner = ChunkRunner(state, train_step, cache, graphed=False)
    for c in _CHUNKS[:2]:
        runner.run(torch.tensor(c, device="cuda"))
        state.end_epoch()
    return state


# ---- the kernels as torch.library ops, and the serving export -------------------------

def _op_args(name, rng):
    """Arguments of ``torch.ops.sdt.<name>`` at a serving shape, and its plain
    version on them with the gate of its kernel's tests (rtol, atol)."""
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1
    from speechdrivestemplates_tpu_torch.ops import in_act as IA
    from speechdrivestemplates_tpu_torch.ops import ln_gelu as LG
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops import shift_probe as SP
    from speechdrivestemplates_tpu_torch.ops import stem as S

    bf = torch.bfloat16
    if name == "in_act":  # layer 3's channels-last activation; one bf16 ulp is 2^-8 relative
        x = _randn(rng, 3, 20, 106, 128).to(bf).permute(0, 3, 1, 2)
        return (x, 0.2), IA.in_act_plain(x, 0.2), (1e-2, 1e-2)
    if name == "ln_gelu":  # the speech encoder's last feature layer, (B, 213, 512) rows
        x = _randn(rng, 3, 213, 512).to(bf)
        b, w, beta = (_randn(rng, 512, scale=0.1).to(bf) + s for s in (0.0, 1.0, 0.0))
        return (x, b, w, beta, 1e-5), LG.ln_gelu_plain(x, b, w, beta, 1e-5), (1e-2, 1e-2)
    if name == "mel":
        audio = _randn(rng, 3, 68267, scale=0.1)
        return ((audio, *M._kernel_tables(audio.device)), M.mel_spectrogram_plain(audio),
                (1e-3, 1e-4))
    w1 = _randn(rng, 64, 1, 3, 3, scale=0.2)
    mel = _randn(rng, 3, 80, 427)
    if name == "conv1_in":
        return (mel, w1, 0.2, torch.float32), C1.conv1_in_plain(mel, w1), (2e-5, 2e-5)
    if name == "stem":
        w2, w3 = _randn(rng, 64, 64, 4, 4, scale=0.05), _randn(rng, 128, 64, 3, 3, scale=0.05)
        y1 = C1.conv1_in_plain(mel, w1)
        wt = [w.permute(2, 3, 0, 1).contiguous() for w in (w2, w3)]
        return (y1, *wt, 0.2), S.stem_tail_plain(y1, w2, w3), (2e-4, 2e-5)
    x, w = _randn(rng, 4, 600, 64, scale=0.1).to(bf), _randn(rng, 9, 64, 64, scale=0.05).to(bf)
    return (x, w, 500, True), SP.shift_taps_plain(x, w, 500), (1e-2, 1e-3)


@pytest.mark.parametrize("name", ["mel", "conv1_in", "stem", "shift_taps", "in_act", "ln_gelu"])
def test_ops_match_their_plain_versions(cuda, name):
    """Each op called through ``torch.ops.sdt`` directly, as an exported graph
    calls it: one launch, the plain version's result within its kernel's gate."""
    from speechdrivestemplates_tpu_torch import kernels

    args, ref, (rtol, atol) = _op_args(name, np.random.RandomState(3))
    kernels.reset_launch_counts()
    got = getattr(torch.ops.sdt, name)(*args)
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) == 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["mel", "conv1_in", "stem", "shift_taps", "in_act", "ln_gelu"])
def test_opcheck(cuda, name):
    """``torch.library.opcheck``: the schema, the fake against the real
    output, the autograd registration, and a trace under AOT dispatch."""
    args, _, _ = _op_args(name, np.random.RandomState(4))
    torch.library.opcheck(getattr(torch.ops.sdt, name), args)


def test_cuda_export_equals_build_serving_fn(cuda, tmp_path):
    """SDT-BP bf16 exported on the card at B = 4: its graph calls mel, conv1
    and the stem once each and in_act 21 times, one call of the loaded
    artifact launches each kernel as often, and its poses are
    ``build_serving_fn``'s on the same inputs."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn
    from speechdrivestemplates_tpu_torch.utils.export import export_serving_fn, load_serving_fn

    cfg = sdt_bp()
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(2)).state_dict()
    ckpt = str(tmp_path / "bp.pth")
    torch.save({"model_state_dict": {"module.netG." + k: v for k, v in sd.items()}}, ckpt)
    meta = export_serving_fn(cfg, ckpt, str(tmp_path / "bp.pt2"), batch_size=4)
    assert meta["device"] == "cuda"
    assert meta["ops"] == {"sdt.conv1_in": 1, "sdt.in_act": 21, "sdt.mel": 1, "sdt.stem": 1}
    art = load_serving_fn(str(tmp_path / "bp.pt2"))
    fn, _ = build_serving_fn(cfg, sd, "cuda")
    rng = np.random.RandomState(5)
    audio, code = _randn(rng, 4, 68267, scale=0.1), _randn(rng, 4, 32)
    kernels.reset_launch_counts()
    got = art(audio, code)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == {"mel": 1, "conv1": 1, "stem": 1, "in_act": 21}
    want = fn(audio, code)
    rel = (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()
    assert got.shape == (4, 64, 2, 121) and rel < 1e-3, rel


def _serving_fn(preset: str, seed: int = 6):
    """A seeded generator's bf16 serving function on the card."""
    from speechdrivestemplates_tpu_torch import config
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    cfg = getattr(config, preset)()
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed)).state_dict()
    return build_serving_fn(cfg, sd, "cuda")


def _serving_kernels(has_code: bool) -> dict:
    return ({"mel": 1, "conv1": 1, "stem": 1, "in_act": 21} if has_code
            else {"mel": 1, "bn_act": 24})


@pytest.mark.parametrize("preset", ["sdt_bp", "s2g"])
def test_graphed_serving_equals_the_eager_forward(cuda, preset):
    """At B = 4, a signature's eager call, its capture call and its replays
    return the same poses, bit for bit, and a replay on other inputs returns
    the module's eager poses of those; the poses a call returned stay as they
    were after later calls, and a replay after the resize matrices' cache was
    cleared still reads the matrices it captured; each call, on every route,
    runs mel (and, with an IN encoder, conv1 and the stem) once, an IN
    generator in_act once a layer after the stem and a BN generator bn_act
    once a layer."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import resize

    fn, has_code = _serving_fn(preset)
    rng = np.random.RandomState(7)

    def inputs():
        return (_randn(rng, 4, 68267, scale=0.1), _randn(rng, 4, 32) if has_code else None)

    a, b = inputs(), inputs()
    kernels.reset_launch_counts()
    outs, ran = [], []
    for args in (a, a, a, b):
        outs.append(fn(*args))
        ran.append(dict(kernels.executions()))
    kept = [o.clone() for o in outs]
    # a replay reads the resize matrices by address: evicted from their cache and
    # the freed memory refilled, they must still hold what the graph captured
    resize._resize_tensor.cache_clear()
    junk = [torch.full((n,), float("nan"), device="cuda") for n in range(1, 4096, 7)]
    again = fn(*a)
    torch.cuda.synchronize()
    del junk
    with torch.inference_mode():
        want_b = fn.module(*b)
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 3}
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])
    assert torch.equal(outs[3], want_b) and not torch.equal(outs[3], outs[0])
    assert torch.equal(again, outs[0])
    assert all(torch.equal(o, k) for o, k in zip(outs, kept))
    per_call = _serving_kernels(has_code)
    assert ran == [{k: n * v for k, v in per_call.items()} for n in range(1, 5)]
    assert dict(kernels.CAPTURED) == per_call  # one capture, four replays
    assert dict(kernels.REPLAYED) == {k: 4 * v for k, v in per_call.items()}


def test_graphed_serving_routes_by_signature(cuda):
    """The route counts read eager, captured, replayed for one signature; a new
    (B, L) starts eagerly; a fifth captured signature evicts the least recently
    used graph, which starts eagerly again, while a replay keeps its graph."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.serving import KEEP_GRAPHS

    fn, _ = _serving_fn("sdt_bp")
    rng = np.random.RandomState(8)
    req = {b: (_randn(rng, b, 16000, scale=0.1), _randn(rng, b, 32)) for b in range(1, 6)}
    longer = (_randn(rng, 1, 20000, scale=0.1), req[1][1])
    kernels.reset_launch_counts()

    def route(args):
        before = collections.Counter(fn.routes)
        fn(*args)
        return next(iter(fn.routes - before))

    assert [route(req[1]) for _ in range(3)] == ["eager", "captured", "replayed"]
    assert route(longer) == "eager"
    for b in (2, 3, 4):
        assert [route(req[b]), route(req[b])] == ["eager", "captured"]
    assert KEEP_GRAPHS == 4 and list(fn.graphs) == [((b, 16000), (b, 32)) for b in (1, 2, 3, 4)]
    assert route(req[2]) == "replayed"  # 2 is now the most recently used
    assert [route(req[5]), route(req[5])] == ["eager", "captured"]  # evicts 1
    assert list(fn.graphs) == [((b, 16000), (b, 32)) for b in (3, 4, 2, 5)]
    assert [route(req[1]), route(req[1])] == ["eager", "captured"]  # evicts 3
    assert [route(req[2]), route(req[3])] == ["replayed", "eager"]
    torch.cuda.synchronize()
    calls = sum(fn.routes.values())
    assert dict(kernels.executions()) == {"mel": calls, "conv1": calls, "stem": calls,
                                          "in_act": 21 * calls}


# ---- eval-mode BN + lrelu + cast in one pass (sdt::bn_act) ------------------------------

# s2g's BN activations at 427 mel frames and 64 pose frames, batch aside: the audio
# encoder's eight 2-D layers, then the 1-D lengths of the UNet and the decoder
S2G_BN_2D = [(64, 80, 427), (64, 40, 213), (128, 40, 213), (128, 20, 106), (256, 20, 106),
             (256, 10, 53), (256, 10, 53), (256, 5, 51)]
S2G_BN_1D = [(256, t) for t in (64, 64, 32, 16, 8, 4, 2, 4, 8, 16, 32, 64, 64, 64, 64, 64)]


def _bn_layer(c, rng):
    """A BatchNorm in eval mode with the benchmark's seeded statistics: scale
    1 + 0.1 N, shift and running mean 0.1 N, running variance exp(0.2 N)."""
    from speechdrivestemplates_tpu_torch.models.blocks import BatchNorm

    bn = BatchNorm(c).cuda().eval()
    with torch.no_grad():
        bn.weight.copy_(1 + _randn(rng, c, scale=0.1))
        bn.bias.copy_(_randn(rng, c, scale=0.1))
        bn.running_mean.copy_(_randn(rng, c, scale=0.1))
        bn.running_var.copy_(torch.exp(_randn(rng, c, scale=0.2)))
    return bn.requires_grad_(False)


def _conv_like(seed, shape, bn, dtype, misaligned=False, channel_dim=1):
    """An activation around the layer's running statistics (sd 1 about each
    channel's mean, the first element of each row exactly at it), in
    ``dtype``, its channels on axis ``channel_dim``; ``misaligned`` puts its
    first element 2 or 4 bytes past a 16-byte boundary."""
    per_channel = [1] * len(shape)
    per_channel[channel_dim] = -1
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * bn.running_var.sqrt().view(per_channel) \
        + bn.running_mean.view(per_channel)
    if channel_dim == len(shape) - 1:  # the first position of each row at the mean
        x[..., 0, :] = bn.running_mean
    else:
        x[..., 0] = bn.running_mean.view(per_channel[:-1])
    x = x.to(dtype)
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(x.flatten())
        x = buf[1:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16
    return x


# (shape, layout): every shape contiguous, as the 1-D layers and the CPU hand it; the 2-D
# encoder's shapes also channels-last, as its convolutions give them on the card (a thread's
# channels fixed: C divides 2,048), and channels-last odd cases: C = 96 (no such C: the
# planes route at S = 1), C = 4 < VEC, and a view 2 or 4 bytes off a 16-byte boundary
BN_ACT_CASES = (
    [((128, *S2G_BN_2D[0]), "contiguous")] + [((2, *s), "contiguous") for s in S2G_BN_2D]
    + [((2, 256, t), "contiguous") for t in (2, 4, 8, 16, 32, 64)]
    + [("misaligned", "contiguous"), ("relu", "contiguous")]
    + [((128, *S2G_BN_2D[0]), "channels_last")] + [((2, *s), "channels_last") for s in S2G_BN_2D]
    + [((2, 96, 7, 9), "channels_last"), ((3, 4, 5, 7), "channels_last"),
       ("misaligned", "channels_last")])


def _bn_act_case_id(case):
    shape, layout = case
    name = "x".join(map(str, shape)) if isinstance(shape, tuple) else shape
    return name if layout == "contiguous" else f"{name}-{layout}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", BN_ACT_CASES, ids=_bn_act_case_id)
def test_bn_act_matches_the_plain_path_within_an_ulp(cuda, case, dtype):
    """``sdt::bn_act`` against the plain path (``BatchNorm`` in eval mode, leaky
    ReLU, the cast back) at s2g's layer shapes, layer 0 at B = 2 and 128:
    within 1 ulp of the compute dtype on every element and bit for bit, one
    launch, counted under the layout it was handed, the output in the input's
    strides. The kernel applies the plain path's fp32 steps in its order; the
    fold into one scale and shift rounds otherwise, and a lower precision
    would miss by many ulps.
    ``misaligned``: a (3, 256, 5, 51) view 2 or 4 bytes off a 16-byte
    boundary takes the element-wise route; ``relu``: slope 0, as the
    discriminator's layers take, at its second layer's (2, 512, 16)."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import bn_act

    shape, layout = case
    rng = np.random.RandomState(11)
    misaligned, slope = shape == "misaligned", 0.0 if shape == "relu" else 0.2
    shape = {"misaligned": (3, 256, 5, 51), "relu": (2, 512, 16)}.get(shape, shape)
    bn = _bn_layer(shape[1], rng)
    if layout == "channels_last":  # made as (B, H, W, C), viewed as (B, C, H, W)
        B, C, H, W = shape
        x = _conv_like(11, (B, H, W, C), bn, dtype, misaligned, channel_dim=3)
        x = x.permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    else:
        x = _conv_like(11, shape, bn, dtype, misaligned)
    before = kernels.LAUNCHES["bn_act"], kernels.LAYOUTS["bn_act", layout]
    with torch.no_grad():
        got = bn_act.bn_act_kernel(x, bn, slope)
        want = bn_act.bn_act_plain(x, bn, slope)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["bn_act"], kernels.LAYOUTS["bn_act", layout]) == \
        (before[0] + 1, before[1] + 1)
    assert got.shape == want.shape == shape and got.dtype == want.dtype == dtype
    assert got.stride() == x.stride()
    assert int(bn_act.ulp_distance(got, want).max()) <= 1
    assert torch.equal(got, want)
    assert torch.isfinite(got.float()).all()


def test_s2g_2d_bn_layers_run_channels_last_on_the_card(cuda):
    """s2g's bf16 generator in eval mode at B = 4: each of the audio
    encoder's 8 2-D BN layers takes and returns a channels-last tensor, on
    the kernels' route and on the plain one, and a forward counts 8
    channels-last bn_act launches and 16 contiguous ones (the 1-D layers)."""
    from speechdrivestemplates_tpu_torch import config, kernels
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import mel as M

    model = build_model("SequenceGeneratorCNN", config.s2g(), device="cuda").eval()
    seen = []

    def hook(module, args, out):
        seen.append((args[0].is_contiguous(memory_format=torch.channels_last),
                     out.is_contiguous(memory_format=torch.channels_last), out.ndim))

    layers = model.audio_encoder.layers()
    handles = [m.register_forward_hook(hook) for m in layers]
    mel = M.mel_spectrogram(_randn(np.random.RandomState(4), 4, 68267, scale=0.1))
    try:
        for plain in (False, True):
            seen.clear()
            kernels.reset_launch_counts()
            with torch.no_grad():
                model(mel, 64, None, plain=plain)
            torch.cuda.synchronize()
            assert seen == [(True, True, 4)] * 8, (plain, seen)
            assert dict(kernels.LAYOUTS) == ({} if plain else {
                ("bn_act", "channels_last"): 8, ("bn_act", "contiguous"): 16})
    finally:
        for h in handles:
            h.remove()


def test_s2g_serving_replay_equals_its_plain_bn_forward_bit_for_bit(cuda):
    """s2g's bf16 serving function at B = 4 with the benchmark's seeded BN
    statistics: its eager call, its capture call and a replay (each 24 bn_act
    launches or replayed executions) return the same poses, bit for bit, and
    those poses are the serving forward with every BN layer on its plain path
    (``plain``), bit for bit."""
    from speechdrivestemplates_tpu_torch import config, kernels
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    cfg = config.s2g()
    rng = np.random.RandomState(13)
    model = build_model("SequenceGeneratorCNN", cfg, device="cpu",
                        generator=torch.Generator().manual_seed(6))
    sd = model.state_dict()
    for k in [k for k in sd if k.endswith(".norm.running_mean")]:
        c = sd[k].numel()
        sd[k] = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
        sd[k[:-4] + "var"] = torch.from_numpy(np.exp(rng.randn(c) * 0.2).astype(np.float32))
        sd[k[:-12] + "weight"] = torch.from_numpy((1 + rng.randn(c) * 0.1).astype(np.float32))
        sd[k[:-12] + "bias"] = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    fn, _ = build_serving_fn(cfg, sd, "cuda")
    audio = _randn(rng, 4, 68267, scale=0.1)
    kernels.reset_launch_counts()
    outs = [fn(audio) for _ in range(3)]
    torch.cuda.synchronize()
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 1}
    assert kernels.executions()["bn_act"] == 3 * 24
    m = fn.module  # ServingModule.forward, with plain BN layers
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        pred = m.model(M.mel_spectrogram(audio), m.num_frames, None, plain=True)
        want = get_final_results(pred, m.mean.expand(4, -1), m.std.expand(4, -1),
                                 m.scale.expand(4), m.hierarchical, m.num_kp)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bn_act"] == before["bn_act"]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], want)


# ---- eval-mode InstanceNorm + lrelu + cast in one pass (sdt::in_act) ---------------------

# SDT-BP's IN activations after the stem at 427 mel frames and 64 pose frames, batch
# aside: audio encoder layers 3-7 (channels-last, as cuDNN leaves them), then the 1-D
# lengths of the UNet and the decoder; layer 3 of the demo's 24 s clip, whose 12,000-row
# planes split over a cluster of 8 blocks; and a 64,000-row plane that no cluster's shared
# memory holds, so that the kernel reads it twice
SDT_IN_2D = [(128, 20, 106), (256, 20, 106), (256, 10, 53), (256, 10, 53), (256, 5, 51)]
SDT_IN_1D = [(256, t) for t in (64, 32, 16, 8, 4, 2)]
DEMO_24S_LAYER3 = (1, 128, 20, 600)
UNCACHED = (1, 8, 64, 1000)


def _in_like(seed, shape, dtype, channels_last=True, misaligned=False):
    """A conv-like activation in ``dtype``: per column (a 2-D (b, c) plane, a
    1-D (b, t) column) a mean of N(0, 1) and a scale of exp(N(0, 0.5)) about
    it; 2-D in channels-last unless asked otherwise; ``misaligned`` puts its
    first element 2 or 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if len(shape) == 4:
        B, C, H, W = shape
        col = (B, C, 1, 1)
    else:
        B, C, T = shape
        col = (B, 1, T)
    x = torch.randn(shape, generator=g, device="cuda") \
        * torch.exp(0.5 * torch.randn(col, generator=g, device="cuda")) \
        + torch.randn(col, generator=g, device="cuda")
    x = x.to(dtype)
    if len(shape) == 4 and channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    if misaligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(x.permute(0, 2, 3, 1).flatten() if x.ndim == 4 else x.flatten())
        x = buf[1:].view(x.permute(0, 2, 3, 1).shape).permute(0, 3, 1, 2) if x.ndim == 4 \
            else buf[1:].view(shape)
        assert x.data_ptr() % 16
    return x


def _in_cases():
    two, one = [(b, *s) for b in (4, 128) for s in SDT_IN_2D], \
        [(b, *s) for b in (4, 128) for s in SDT_IN_1D]
    return two + one + [DEMO_24S_LAYER3, UNCACHED, "misaligned2d", "misaligned1d", "nchw"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", _in_cases(),
                         ids=lambda s: "x".join(map(str, s)) if isinstance(s, tuple) else s)
def test_in_act_matches_the_plain_path(cuda, case, dtype):
    """``sdt::in_act`` against the plain path (``instance_norm_2d`` or
    ``channel_norm_1d``, leaky ReLU, the cast back) at SDT-BP's five 2-D and
    six 1-D IN shapes at B = 4 and 128, the demo's 24 s layer 3 at B = 1 (a
    cluster of blocks), a plane no cluster's shared memory holds (read twice),
    misaligned views (the element-wise route) and a contiguous NCHW plane (the
    row form): one
    launch, the input's strides; the kernel's mean and biased variance within
    1e-5 of ``var_mean``'s, relative to the column's |mean| + std and to its
    variance; the output equal, bit for bit, to the plain path's steps taken
    with the kernel's statistics; and against the plain path itself, fp32
    within 2e-6 x max(1, |plain|), bf16 within that and one bf16 ulp of the
    plain value (the statistics differ from ``var_mean``'s by fp32 round-off,
    which near a column's mean is many bf16 ulps of a value near 0: the share
    of elements one ulp off and of those further off are printed)."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import bn_act, in_act

    shape = {"misaligned2d": (3, 256, 5, 51), "misaligned1d": (3, 256, 64),
             "nchw": (4, 128, 20, 106)}.get(case, case)
    x = _in_like(17, shape, dtype, channels_last=case != "nchw",
                 misaligned=str(case).startswith("misaligned"))
    before = kernels.LAUNCHES["in_act"]
    with torch.no_grad():
        got, mean, var = in_act.in_act_kernel_stats(x, 0.2)
        want = in_act.in_act_plain(x, 0.2)
        dims, col = ((-2, -1), mean[:, :, None, None]) if x.ndim == 4 else (1, mean[:, None])
        want_var, want_mean = torch.var_mean(x.float(), dim=dims, correction=0)
        rstd = torch.rsqrt(var.view(col.shape) + 1e-5)
        own = torch.nn.functional.leaky_relu((x.float() - col) * rstd, 0.2).to(dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["in_act"] == before + 1
    assert got.shape == want.shape == shape and got.dtype == want.dtype == dtype
    assert got.stride() == x.stride() and torch.isfinite(got.float()).all()
    scale = want_mean.abs() + want_var.sqrt()
    assert ((mean - want_mean).abs() <= 1e-5 * scale).all()
    assert ((var - want_var).abs() <= 1e-5 * want_var).all()
    assert torch.equal(got, own)
    g, w = got.float(), want.float()
    gate = 2e-6 * w.abs().clamp(min=1)
    if dtype == torch.bfloat16:
        ulps = bn_act.ulp_distance(got, want)
        far = ulps > 1
        print(f"in_act {case} bf16: {ulps.eq(1).float().mean().item():.3e} of elements 1 ulp "
              f"off, {far.float().mean().item():.3e} further (max |diff| "
              f"{(g - w).abs()[far].max().item() if far.any() else 0.0:.3e})")
        gate = gate + torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    assert ((g - w).abs() <= gate).all(), ((g - w).abs() - gate).max().item()


def test_serving_layers_reach_in_act_channels_last(cuda):
    """In SDT-BP's bf16 serving forward at B = 4, cuDNN leaves the convolutions
    of audio encoder layers 3-7 channels-last (the stem's output is its
    permuted view), so in_act takes them in the column form; the 1-D layers
    hand it contiguous (B, 256, T)."""
    from speechdrivestemplates_tpu_torch.kernels.ops import in_act_slab
    from speechdrivestemplates_tpu_torch.ops import in_act

    fn, _ = _serving_fn("sdt_bp")
    seen = []
    real = in_act.in_act_kernel

    def spy(y, slope):
        seen.append((y.ndim, in_act_slab(y)))
        return real(y, slope)

    rng = np.random.RandomState(19)
    in_act.in_act_kernel = spy
    try:
        with torch.inference_mode():
            fn.module(_randn(rng, 4, 68267, scale=0.1), _randn(rng, 4, 32))
    finally:
        in_act.in_act_kernel = real
    assert [s for n, s in seen if n == 4] == [(4, h * w, c) for c, h, w in SDT_IN_2D]
    assert len(seen) == 21 and all(s[0] == 4 and s[1] == 256 for n, s in seen if n == 3)


def test_sdt_bp_serving_replay_against_its_plain_forward(cuda):
    """SDT-BP's bf16 serving function at B = 4: its eager call, its capture
    call and a replay (21 in_act launches or replayed executions each) return
    the same poses, bit for bit; the same forward with every IN layer on its
    plain path (``plain``, and the mel kernel's spectrogram) lies within rel
    L2 2e-2 of them, the bf16 gate the s2g forward is held to."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results

    fn, _ = _serving_fn("sdt_bp")
    rng = np.random.RandomState(21)
    audio, code = _randn(rng, 4, 68267, scale=0.1), _randn(rng, 4, 32)
    kernels.reset_launch_counts()
    outs = [fn(audio, code) for _ in range(3)]
    torch.cuda.synchronize()
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 1}
    assert kernels.executions()["in_act"] == 3 * 21
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    m = fn.module
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        pred = m.model(M.mel_spectrogram(audio), m.num_frames, code, plain=True)
        want = get_final_results(pred, m.mean.expand(4, -1), m.std.expand(4, -1),
                                 m.scale.expand(4), m.hierarchical, m.num_kp)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["in_act"] == before["in_act"]
    rel = (torch.linalg.norm(outs[0].float() - want.float())
           / torch.linalg.norm(want.float())).item()
    print(f"in_act SDT-BP serving B=4 bf16: rel L2 to the plain forward {rel:.3e}")
    assert rel < 2e-2, rel


# a speech encoder small enough to build in a second: published kernels and
# strides, every width cut
HUBERT_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4)


# WavLM's at those widths: no conv bias, 16 buckets spaced by the log up to 12
# frames, so that a 17 s window's 853 frames run the log branch and the clamp
WAVLM_TINY = dict(HUBERT_TINY, conv_bias=False, num_buckets=16, max_bucket_distance=12)


def _hubert_fn(monkeypatch, tiny: bool, seed: int = 8, name: str = "SequenceGeneratorHuBERT",
               opts=()):
    """SDT-HuBERT's bf16 serving function on the card (or, by ``name``,
    SDT-WavLM's), at HUBERT_TINY (WAVLM_TINY) or the published widths
    (``speech_encoder.HUBERT_LARGE``, ``WAVLM_LARGE``), and its layer count;
    ``opts`` override the preset's keys."""
    from speechdrivestemplates_tpu_torch import config, models
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    wavlm = name == "SequenceGeneratorWavLM"
    cls = models.MODELS[name]
    if tiny:
        cls = type("Tiny", (cls,), {"SPEC": SE.SpeechEncoderSpec(
            **(WAVLM_TINY if wavlm else HUBERT_TINY))})
        monkeypatch.setitem(models.MODELS, name, cls)
    cfg = config.apply_overrides((config.sdt_wavlm if wavlm else config.sdt_hubert)(),
                                 list(opts))
    sd = models.build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed)).state_dict()
    fn, has_code = build_serving_fn(cfg, sd, "cuda")
    assert has_code
    return fn, cls.SPEC.num_hidden_layers


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_speech_encoder_card_forward_against_its_plain_forward(cuda, monkeypatch, tiny):
    """At B = 2 in bf16, the card's forward (flash attention, one call a
    layer, no math-backend call; the feature encoder's norm by ``ln_gelu``,
    7 launches) lies within rel L2 2e-2 of the same weights' ``plain``
    forward (the math backend, the feature encoder's convolution with its
    bias, LayerNorm and GELU, and the UNet's and decoder's plain IN layers,
    none launching ``ln_gelu``), the bf16 gate SDT-BP's and s2g's serving
    forwards are held to."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results

    fn, layers = _hubert_fn(monkeypatch, tiny)
    rng = np.random.RandomState(31)
    audio, code = _randn(rng, 2, 68267, scale=0.1), _randn(rng, 2, 32)
    kernels.reset_launch_counts()
    got = fn(audio, code)
    torch.cuda.synchronize()
    assert dict(kernels.ATTENTION) == {"flash": layers}
    assert kernels.LAUNCHES["ln_gelu"] == 7
    m = fn.module
    with torch.inference_mode():
        pred = m.model(m.model.features(audio, True), m.num_frames, code, plain=True)
        want = get_final_results(pred, m.mean.expand(2, -1), m.std.expand(2, -1),
                                 m.scale.expand(2), m.hierarchical, m.num_kp)
    assert dict(kernels.ATTENTION) == {"flash": layers, "math": layers}
    assert kernels.LAUNCHES["ln_gelu"] == 7
    rel = (torch.linalg.norm(got.float() - want.float())
           / torch.linalg.norm(want.float())).item()
    print(f"SDT-HuBERT {'tiny' if tiny else 'published'} B=2 bf16: rel L2 card to plain "
          f"{rel:.3e}")
    assert got.shape == (2, 64, 2, 121) and rel < 2e-2, rel


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_speech_encoder_serving_replay_equals_eager(cuda, monkeypatch, tiny):
    """The serving function's eager call, its capture call and two replays
    return the same poses, bit for bit; attention is counted at the eager call
    and the capture (flash, once a layer each) and not at replays; each call
    executes ``ln_gelu`` 7 times. At the tiny
    size, new weights loaded into the module after the capture reach the
    replay (the cache of folded, cast weights is refreshed in place): the
    replay then equals the module's eager forward on them."""
    from speechdrivestemplates_tpu_torch import kernels, models

    fn, layers = _hubert_fn(monkeypatch, tiny)
    rng = np.random.RandomState(32)
    audio, code = _randn(rng, 2, 68267, scale=0.1), _randn(rng, 2, 32)
    kernels.reset_launch_counts()
    outs = [fn(audio, code) for _ in range(4)]
    torch.cuda.synchronize()
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 2}
    diff = [float((o.float() - outs[0].float()).abs().max()) for o in outs[1:]]
    assert bool(torch.isfinite(outs[0]).all()) and diff == [0.0] * 3, diff
    assert dict(kernels.ATTENTION) == {"flash": 2 * layers}
    assert kernels.executions()["ln_gelu"] == 4 * 7
    if not tiny:
        return
    sd = models.MODELS["SequenceGeneratorHuBERT"](
        121, 32, generator=torch.Generator().manual_seed(9)).state_dict()
    fn.module.model.load_state_dict(sd, strict=True)
    replayed = fn(audio, code)
    with torch.inference_mode():
        eager = fn.module(audio, code)
    assert torch.equal(replayed, eager) and not torch.equal(replayed, outs[0])


# ---- WavLM's gated relative-position attention --------------------------------------------

# WavLM Large's window in the benchmark: 17.07 s, 256 pose-frames, 853 encoder frames
WAVLM_WINDOW = ["DATASET.NUM_FRAMES", "256", "DATASET.AUDIO_LENGTH", "273067"]


def _biased_inputs(seed, batch, t):
    """WavLM Large's attention at ``batch`` clips of ``t`` frames in bf16: Q, K,
    V (B, 16, t, 64) as the layers' maps give them (entries ~N(0, 0.4)), the
    table of a N(0, 1) bucket embedding at (320, 800), and a layer's gated bias
    from gate sums ~N(0, 2) and constants 1 + 0.5 z, the T-wide view of its
    (.., t, T_pad) buffer."""
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    q, k, v = ((0.4 * randn(batch, 16, t, 64)).to(torch.bfloat16) for _ in range(3))
    table = SE.position_table(randn(16, 320).to(torch.bfloat16), t, 320, 800)
    bias = SE.gated_bias(table, 2.0 * randn(batch, t, 16, 2), 1.0 + 0.5 * randn(16))
    return q, k, v, bias[..., :t]


def test_wavlm_biased_attention_against_the_plain_route(cuda):
    """At WavLM Large's heads (16 of 64) and T = 853, B = 2, bf16: the card's
    biased route (the forced ``BIASED_BACKEND``, counted once) reads the bias
    as the T-wide view of its buffer, every row 16-aligned, without padding it
    again (no ``aten::pad`` / ``constant_pad_nd`` among the call's ops), and lies within
    rel L2 2e-2 of the ``plain`` route (the math backend, counted once) and of
    float32 math, each of which is within 1e-2 of the other."""
    from torch.profiler import ProfilerActivity, profile

    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

    q, k, v, bias = _biased_inputs(41, 2, 853)
    assert bias.shape == (2, 16, 853, 853) and bias.stride(-1) == 1
    assert all(x % 16 == 0 for x in bias.stride()[:-1]), bias.stride()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = SE.attention(q, k, v, bias)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::pad", "aten::constant_pad_nd"}, sorted(ops)
    plain = SE.attention(q, k, v, bias, plain=True)
    assert dict(kernels.ATTENTION) == {SE.BIASED_BACKEND: 1, "math": 1}
    want = torch.softmax(q.float() @ k.float().transpose(-1, -2) / 8.0 + bias.float(), -1) \
        @ v.float()

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    print(f"WavLM attention T=853 bf16: {SE.BIASED_BACKEND} vs plain {rel(got, plain):.3e}, "
          f"vs fp32 {rel(got, want):.3e}; plain vs fp32 {rel(plain, want):.3e}")
    assert rel(got, plain) < 2e-2 and rel(got, want) < 2e-2 and rel(plain, want) < 1e-2


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_wavlm_card_forward_against_its_plain_forward(cuda, monkeypatch, tiny):
    """SDT-WavLM's bf16 serving call at B = 2 over 17 s windows (853 encoder
    frames): every layer's attention on the forced biased backend, no flash or
    math call; ``ln_gelu`` 7 launches with the convolutions' zero bias; within
    rel L2 2e-2 of the same weights' ``plain`` forward (the math backend, the
    convolutions without bias, the plain LayerNorm and GELU, the plain IN
    layers)."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results

    fn, layers = _hubert_fn(monkeypatch, tiny, name="SequenceGeneratorWavLM",
                            opts=WAVLM_WINDOW)
    rng = np.random.RandomState(34)
    audio, code = _randn(rng, 2, 273067, scale=0.1), _randn(rng, 2, 32)
    kernels.reset_launch_counts()
    got = fn(audio, code)
    torch.cuda.synchronize()
    assert dict(kernels.ATTENTION) == {SE.BIASED_BACKEND: layers}
    assert kernels.LAUNCHES["ln_gelu"] == 7
    m = fn.module
    with torch.inference_mode():
        pred = m.model(m.model.features(audio, True), m.num_frames, code, plain=True)
        want = get_final_results(pred, m.mean.expand(2, -1), m.std.expand(2, -1),
                                 m.scale.expand(2), m.hierarchical, m.num_kp)
    assert dict(kernels.ATTENTION) == {SE.BIASED_BACKEND: layers, "math": layers}
    rel = (torch.linalg.norm(got.float() - want.float())
           / torch.linalg.norm(want.float())).item()
    print(f"SDT-WavLM {'tiny' if tiny else 'published'} B=2 bf16: rel L2 card to plain "
          f"{rel:.3e}")
    assert got.shape == (2, 256, 2, 121) and rel < 2e-2, rel


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_wavlm_serving_replay_equals_eager(cuda, monkeypatch, tiny):
    """SDT-WavLM's eager call, capture call and two replays return the same
    poses, bit for bit; the biased attention is counted at the eager call and
    the capture, once a layer each, and not at replays; the position table's
    span opens once a host-run call, inside ``encoder.transformer``."""
    from torch.profiler import ProfilerActivity, profile

    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE
    from speechdrivestemplates_tpu_torch.utils import trace

    fn, layers = _hubert_fn(monkeypatch, tiny, name="SequenceGeneratorWavLM",
                            opts=WAVLM_WINDOW)
    rng = np.random.RandomState(35)
    audio, code = _randn(rng, 2, 273067, scale=0.1), _randn(rng, 2, 32)
    kernels.reset_launch_counts()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = [fn(audio, code) for _ in range(4)]
        torch.cuda.synchronize()
    rows, parents = list(trace.RECORDER.rows), list(trace.RECORDER.parents)
    trace.reset()
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 2}
    diff = [float((o.float() - outs[0].float()).abs().max()) for o in outs[1:]]
    assert bool(torch.isfinite(outs[0]).all()) and diff == [0.0] * 3, diff
    assert dict(kernels.ATTENTION) == {SE.BIASED_BACKEND: 2 * layers}
    table = [i for i, r in enumerate(rows) if r[0] == "encoder.position_bias"]
    assert len(table) == 2 and all(rows[parents[i]][0] == "encoder.transformer" for i in table)


def test_hubert_stays_on_flash_beside_wavlm(cuda, monkeypatch):
    """With WavLM's biased route in the rule, a tiny SDT-HuBERT serving call
    still runs flash alone, once a layer, and builds no position table."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

    tables = []
    monkeypatch.setattr(SE, "position_table", lambda *a: tables.append(a))
    fn, layers = _hubert_fn(monkeypatch, True)
    rng = np.random.RandomState(36)
    kernels.reset_launch_counts()
    fn(_randn(rng, 2, 68267, scale=0.1), _randn(rng, 2, 32))
    torch.cuda.synchronize()
    assert dict(kernels.ATTENTION) == {"flash": layers} and not tables


# ---- the speech encoder's feature-encoder norm in one pass (sdt::ln_gelu) -----------------

# HuBERT Large's feature-encoder outputs at 68,267 samples, batch aside: (T_i, C)
HUBERT_FEATURES = [(13652, 512), (6825, 512), (3412, 512), (1705, 512), (852, 512), (426, 512),
                   (213, 512)]
# HUBERT_TINY's last layer (C = 32: one chunk, 4 lanes a row), a chunk a 512-byte row does
# not fill (C = 40), and the widest C the kernel takes (four bf16 chunks, eight fp32)
LN_GELU_OTHER = [(4, 19, 32), (3, 50, 40), (2, 37, 1024)]


def _ln_like(seed, shape, dtype):
    """A convolution-like (..., C) activation in ``dtype`` (per row a mean of
    N(0, 1) and a scale of exp(N(0, 0.5)), per channel an offset of N(0,
    0.5)) and a LayerNorm's bias, weight and beta in ``dtype``: 0.1 z, 1 +
    0.1 z and 0.1 z."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]

    def randn(*s):
        return torch.randn(s, generator=g, device="cuda")

    x = randn(*shape) * torch.exp(0.5 * randn(*shape[:-1], 1)) + randn(*shape[:-1], 1) \
        + 0.5 * randn(c)
    return x.to(dtype), (0.1 * randn(c)).to(dtype), (1 + 0.1 * randn(c)).to(dtype), \
        (0.1 * randn(c)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(4, t, c) for t, c in HUBERT_FEATURES] + LN_GELU_OTHER,
                         ids=lambda s: "x".join(map(str, s)))
def test_ln_gelu_matches_the_plain_path(cuda, shape, dtype):
    """``sdt::ln_gelu`` against ``ln_gelu_plain`` (the bias, ``F.layer_norm``
    and ``F.gelu`` in fp32, cast once) at the seven published feature-layer
    shapes at B = 4, HUBERT_TINY's C = 32, a C that leaves a chunk part-filled
    and the widest C: one launch, a contiguous output of the input's shape
    and dtype; fp32 within 2e-6 x max(1, |plain|), bf16 within that and one
    bf16 ulp of the plain value (the statistics sum in another order than
    ``F.layer_norm``'s Welford reduction, an fp32 round-off; the share of
    elements one ulp off is printed)."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import bn_act, ln_gelu

    x, b, w, beta = _ln_like(23, shape, dtype)
    before = kernels.LAUNCHES["ln_gelu"]
    with torch.no_grad():
        got = ln_gelu.ln_gelu_kernel(x, b, w, beta, 1e-5)
        want = ln_gelu.ln_gelu_plain(x, b, w, beta, 1e-5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ln_gelu"] == before + 1
    assert got.shape == want.shape == shape and got.dtype == want.dtype == dtype
    assert got.is_contiguous() and torch.isfinite(got.float()).all()
    g, v = got.float(), want.float()
    gate = 2e-6 * v.abs().clamp(min=1)
    if dtype == torch.bfloat16:
        ulps = bn_act.ulp_distance(got, want)
        print(f"ln_gelu {shape} bf16: {ulps.eq(1).float().mean().item():.3e} of elements 1 ulp "
              f"off, {ulps.gt(1).float().mean().item():.3e} further")
        gate = gate + torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)
    assert ((g - v).abs() <= gate).all(), ((g - v).abs() - gate).max().item()


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
def test_hubert_serving_runs_ln_gelu_seven_times_a_call_on_channels_last_rows(cuda, monkeypatch,
                                                                              tiny):
    """SDT-HuBERT's bf16 serving function at B = 2: the eager call, the
    capture call and a replay each execute ``ln_gelu`` 7 times (7 launches at
    each host run, 7 captured, and 7 replayed by each of the capture call's
    and the third call's replays), and every feature-encoder convolution
    writes its output channels-last, so the kernel reads its (B, T, C) rows
    without a copy."""
    from speechdrivestemplates_tpu_torch import kernels

    fn, _ = _hubert_fn(monkeypatch, tiny)
    conv2d, dense = torch.nn.functional.conv2d, []

    def spy(*args, **kwargs):
        y = conv2d(*args, **kwargs)
        dense.append(y.squeeze(2).transpose(1, 2).is_contiguous())
        return y

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    rng = np.random.RandomState(33)
    audio, code = _randn(rng, 2, 68267, scale=0.1), _randn(rng, 2, 32)
    kernels.reset_launch_counts()
    outs = [fn(audio, code) for _ in range(3)]
    torch.cuda.synchronize()
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 1}
    assert dense == [True] * 14  # the eager call's and the capture's convolutions
    assert (kernels.LAUNCHES["ln_gelu"], kernels.CAPTURED["ln_gelu"],
            kernels.REPLAYED["ln_gelu"], kernels.executions()["ln_gelu"]) == (14, 7, 14, 21)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("preset", ["sdt_bp", "s2g"])
def test_cnn_serving_never_runs_ln_gelu(cuda, preset):
    """SDT-BP's and s2g's serving calls (eager, capture, replay) run no
    speech encoder, so ``ln_gelu`` is never launched or replayed."""
    from speechdrivestemplates_tpu_torch import kernels

    fn, has_code = _serving_fn(preset)
    rng = np.random.RandomState(34)
    args = (_randn(rng, 2, 68267, scale=0.1), _randn(rng, 2, 32) if has_code else None)
    kernels.reset_launch_counts()
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    assert dict(fn.routes) == {"eager": 1, "captured": 1, "replayed": 1}
    assert kernels.executions()["mel"] == 3 and kernels.executions()["ln_gelu"] == 0
    assert "ln_gelu" not in kernels.LAUNCHES and "ln_gelu" not in kernels.REPLAYED
