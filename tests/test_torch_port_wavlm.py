"""SDT-WavLM (``models/speech_encoder.py``'s ``SequenceGeneratorWavLM``) on
the CPU at a tiny size: HuBERT's tiny widths (hidden 64, 2 layers of 4
heads, inner 128, 7 x 32 conv channels at the published kernels and strides,
a positional convolution of 16 taps in 4 groups), convolutions without bias,
16 relative-position buckets spaced by the log up to 12 frames, so that the
clips' 19 encoder frames run the exact buckets, the log-spaced ones and the
clamp; seeded random weights (the benchmark's seeded kinds).

The benchmark's plain reference (``benchmark/reference/wavlm.py``) is held
to transformers' ``WavLMModel`` (built here from a config, nothing
downloaded); the port's generator, with and without ``plain``, and its
serving function at the benchmark's 17 s window to the reference; the bucket
function to its formula at the published (320, 800); the attention rule; the
eval and demo steps; the export's refusal. The published widths are built on
the meta device only, where their parameters are counted against
``WavLMModel``'s."""

import math
import os

import pytest
import torch

from benchmark import weights as bench_weights
from benchmark.models import sdt_wavlm as bench_model
from benchmark.reference import pose as ref_pose
from benchmark.reference import speech_encoder as ref_se
from benchmark.reference import wavlm as ref_wavlm
from speechdrivestemplates_tpu_torch import config, kernels, models
from speechdrivestemplates_tpu_torch.models import speech_encoder as SE
from speechdrivestemplates_tpu_torch.utils import trace

TINY = SE.SpeechEncoderSpec(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, conv_dim=(32,) * 7,
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                            conv_bias=False, num_buckets=16, max_bucket_distance=12)
SAMPLES = 6400  # 19 encoder frames
# the reference's model entry at the tiny widths (the benchmark's keys)
M = {**{k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(TINY).items()},
     "norm": "IN", "code_dim": 32, "leaky_slope": 0.2, "num_landmarks": 121,
     "num_frames": 64, "hierarchical_pose": True}
WINDOW = ["DATASET.NUM_FRAMES", "256", "DATASET.AUDIO_LENGTH", "273067"]


class TinyWavLM(SE.SequenceGeneratorWavLM):
    SPEC = TINY


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """Seeded weights by the reference's names, a batch of 3 clips and codes,
    and the reference's normalized and pixel-space poses of them."""
    w = bench_weights.seeded_weights(bench_model, M, 2 ** 33 + 7, "cpu")
    g = torch.Generator().manual_seed(2)
    audio = 0.1 * torch.randn(3, SAMPLES, generator=g)
    code = torch.randn(3, 32, generator=g)
    stat = ref_pose.speaker_stat("oliver", True)
    with torch.no_grad():
        pred = ref_wavlm.forward(w, audio, 64, code, M)
    return dict(w=w, audio=audio, code=code, stat=stat,
                poses=ref_pose.final_poses(pred, stat, True))


def _generator(w, dtype):
    gen = TinyWavLM(121, 32, dtype=dtype).eval()
    gen.load_state_dict(bench_model.port_state_dict(w), strict=True)
    return gen


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


def _wavlm_config(transformers, **widths):
    return transformers.WavLMConfig(
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=False,
        hidden_act="gelu", feat_extract_activation="gelu", layer_norm_eps=1e-5, **widths)


def test_reference_encoder_equals_transformers_wavlm(tiny):
    """transformers' ``WavLMModel`` with WavLM Large's flags at the tiny widths,
    given the same weights (its weight-norm parametrization's ``original0`` /
    ``original1`` are ``weight_g`` / ``weight_v``), returns the reference
    encoder's ``last_hidden_state`` within 1e-5 of its largest value: both
    float32 on the same operations, summed in other orders (measured 1e-6).
    Every one of its parameters has a seeded leaf of the same name."""
    transformers = _transformers()
    hc = _wavlm_config(transformers, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                       intermediate_size=128, conv_dim=(32,) * 7, conv_kernel=TINY.conv_kernel,
                       conv_stride=TINY.conv_stride, num_conv_pos_embeddings=16,
                       num_conv_pos_embedding_groups=4, num_buckets=16, max_bucket_distance=12)
    hm = transformers.WavLMModel(hc).eval()
    names = {"parametrizations.weight.original0": "weight_g",
             "parametrizations.weight.original1": "weight_v"}
    sd = {}
    for k, v in hm.state_dict().items():
        mine = k
        for a, b in names.items():
            mine = mine.replace(a, b)
        sd[k] = v if k == "masked_spec_embed" else tiny["w"]["audio_encoder." + mine]
    assert len(sd) - 1 == len([n for n in tiny["w"] if n.startswith("audio_encoder.")])
    hm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want = hm(ref_se.normalize(tiny["audio"])).last_hidden_state
        got = ref_wavlm.encoder(tiny["w"], tiny["audio"], M)
    assert got.shape == want.shape == (3, 19, 64)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"reference vs WavLMModel: max |diff| / max |value| {err:.2e}")
    assert err < 1e-5, err


@pytest.mark.parametrize("dtype,plain,tol", [(torch.float32, False, 1e-5),
                                             (torch.float32, True, 1e-5),
                                             (torch.bfloat16, False, 3e-2)],
                         ids=["fp32", "fp32-plain", "bf16"])
def test_port_generator_equals_the_reference_in_poses(tiny, dtype, plain, tol):
    """The port's eval forward (the cached weights, the gate in the Q, K, V
    matmul, the math attention with the gated bias on the CPU) against the
    reference's pixel-space poses, rel L2: float32 within 1e-5 with and
    without ``plain`` (measured 7e-7); bf16 within 3e-2 (measured 1e-2)."""
    gen = _generator(tiny["w"], dtype)
    kernels.ATTENTION.clear()
    with torch.no_grad():
        pred = gen(gen.features(tiny["audio"], plain), 64, tiny["code"], plain=plain)
    got = ref_pose.final_poses(pred.float(), tiny["stat"], True)
    rel = _rel(got, tiny["poses"])
    print(f"port {dtype} plain={plain} vs reference: rel L2 {rel:.2e}")
    assert pred.dtype == dtype and got.shape == (3, 64, 2, 121) and rel < tol, rel
    assert dict(kernels.ATTENTION) == {"math": 2}


def test_the_bucket_function_is_the_formula_at_the_published_buckets():
    """At (320, 800), for every offset r in -1,200..1,200: the port's and the
    reference's buckets are ``160 [r > 0] + (|r| if |r| < 80 else min(159,
    floor(80 + ln(|r| / 80) / ln(10) x 80)))``, exactly; the table's columns
    follow j - i."""
    r = torch.arange(-1200, 1201)
    want = torch.tensor([160 * (x > 0) + (abs(x) if abs(x) < 80 else
                                          min(159, math.floor(80 + math.log(abs(x) / 80)
                                                              / math.log(10) * 80)))
                         for x in r.tolist()])
    assert torch.equal(SE.relative_position_bucket(r, 320, 800), want)
    assert torch.equal(ref_wavlm.bucket(r, 320, 800), want)
    embed = torch.arange(2 * 320, dtype=torch.float32).view(2, 320)
    table = SE.position_table(embed, 853, 320, 800)
    assert table.shape == (2, 853, 864) and table.is_contiguous()
    i, j = torch.meshgrid(torch.arange(853), torch.arange(864), indexing="ij")
    assert torch.equal(table[1], embed[1, want[j - i + 1200]])


@pytest.mark.parametrize("device,dtype,biased,plain,want", [
    ("cuda", torch.bfloat16, False, False, "flash"),
    ("cuda", torch.float16, False, False, "flash"),
    ("cuda", torch.bfloat16, True, False, SE.BIASED_BACKEND),
    ("cuda", torch.float16, True, False, SE.BIASED_BACKEND),
    ("cuda", torch.bfloat16, True, True, "math"),
    ("cuda", torch.bfloat16, False, True, "math"),
    ("cuda", torch.float32, True, False, "math"),
    ("cuda", torch.float32, False, False, "math"),
    ("cpu", torch.bfloat16, True, False, "math"),
    ("cpu", torch.bfloat16, False, False, "math")])
def test_the_attention_rule(device, dtype, biased, plain, want):
    """One rule, no setting: on the card in bf16 or fp16 without ``plain``,
    flash without a bias and cuDNN's attention with one (measured 2.2x the
    memory-efficient kernel's speed at the cell's shape); math otherwise."""
    assert SE.attention_backend(device, dtype, biased, plain) == want
    assert SE.BIASED_BACKEND == "cudnn"


def test_serving_fn_at_the_17_s_window_returns_the_reference_poses(tiny, monkeypatch):
    """``build_serving_fn`` of the ``voice2pose_sdt_wavlm`` preset in fp32 at
    the benchmark's window (256 pose-frames of 273,067 samples, 853 encoder
    frames: the resize and the UNet at 4x SDT's clip) returns the reference's
    pixel-space poses within rel L2 1e-5; a traced call opens
    ``encoder.position_bias`` once, inside ``encoder.transformer``."""
    from torch.profiler import ProfilerActivity, profile

    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    monkeypatch.setitem(models.MODELS, "SequenceGeneratorWavLM", TinyWavLM)
    cfg = config.apply_overrides(config.sdt_wavlm(precision="fp32"), WINDOW)
    fn, has_code = build_serving_fn(cfg, bench_model.port_state_dict(tiny["w"]), "cpu")
    audio = 0.1 * torch.randn(2, 273067, generator=torch.Generator().manual_seed(5))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = fn(audio, tiny["code"][:2])
    rows, parents = list(trace.RECORDER.rows), list(trace.RECORDER.parents)
    trace.reset()
    with torch.no_grad():
        want = ref_pose.final_poses(ref_wavlm.forward(tiny["w"], audio, 256, tiny["code"][:2], M),
                                    tiny["stat"], True)
    assert has_code and dict(fn.routes) == {"eager": 1}
    rel = _rel(got, want)
    assert got.shape == (2, 256, 2, 121) and rel < 1e-5, rel
    names = [r[0] for r in rows]
    assert names == ["serve.forward", "encoder.features", "encoder.transformer",
                     "encoder.position_bias", "unet", "decoder", "final"]
    assert rows[parents[3]][0] == "encoder.transformer"


def test_eval_and_demo_steps_reach_the_generator(tiny, monkeypatch):
    """The preset's eval step at the tiny widths returns the reference's poses
    of the batch's codes; the demo step of one clip at its own length runs
    the same forward."""
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                     demo_step, eval_step)

    monkeypatch.setitem(models.MODELS, "SequenceGeneratorWavLM", TinyWavLM)
    cfg = config.sdt_wavlm(precision="fp32")
    state = Voice2PoseTrainState(cfg, 8, "cpu")
    state.generator.load_state_dict(bench_model.port_state_dict(tiny["w"]), strict=True)
    assert isinstance(state.generator, SE.SequenceGeneratorWavLM)
    batch = train_batch(cfg, 2, 8, "cpu")
    batch["audio"] = tiny["audio"][:2]
    _, res = eval_step(state, batch, fixed_code=tiny["code"][:2])
    stat = {k: batch["speaker_stat"][k] for k in ("mean", "std", "scale_factor")}
    with torch.no_grad():
        pred = ref_wavlm.forward(tiny["w"], tiny["audio"][:2], 64, tiny["code"][:2], M)
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results

    want = get_final_results(pred, stat["mean"], stat["std"], stat["scale_factor"], True, 121)
    assert _rel(res["poses_pred_batch"], want) < 1e-5
    demo = {"audio": tiny["audio"][:1], "num_frames": torch.tensor([40]),
            "speaker_stat": {k: v[:1] for k, v in batch["speaker_stat"].items()}}
    out = demo_step(state, demo)
    assert out["poses_pred_batch"].shape == (1, 40, 2, 121)
    assert bool(torch.isfinite(out["poses_pred_batch"]).all())


def test_the_export_refuses_the_waveform_generator(tmp_path):
    """The serving export covers mel-input generators: it refuses SDT-WavLM
    by its ``MEL_INPUT``, before any weights load."""
    from speechdrivestemplates_tpu_torch.utils.export import export_serving_fn

    assert not SE.SequenceGeneratorWavLM.MEL_INPUT
    with pytest.raises(ValueError, match="mel-input generators only"):
        export_serving_fn(config.sdt_wavlm(precision="fp32"), str(tmp_path / "absent.pth"),
                          str(tmp_path / "out.pt2"), device="cpu")


def test_the_preset_builds_wavlm_large_with_transformers_names_and_count():
    """``build_model`` of the ``voice2pose_sdt_wavlm`` preset's generator name,
    on the meta device: WavLM Large's published widths, and the encoder's
    state-dict names and count, 315,452,096, those of transformers'
    ``WavLMModel`` at the published config without ``masked_spec_embed``
    (its weight norm's ``original0`` / ``original1`` as ``weight_g`` /
    ``weight_v``): the bucket embedding in layer 0 alone, the gate in every
    layer, no convolution bias."""
    transformers = _transformers()
    cfg = config.sdt_wavlm()
    assert cfg.VOICE2POSE.GENERATOR.NAME == "SequenceGeneratorWavLM"
    with torch.device("meta"):
        gen = models.MODELS[cfg.VOICE2POSE.GENERATOR.NAME].from_cfg(
            cfg, models.compute_dtype(cfg))
        hm = transformers.WavLMModel(_wavlm_config(
            transformers, hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, conv_dim=(512,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
            conv_stride=(5, 2, 2, 2, 2, 2, 2), num_conv_pos_embeddings=128,
            num_conv_pos_embedding_groups=16, num_buckets=320, max_bucket_distance=800))
    spec = SE.WAVLM_LARGE
    assert gen.audio_encoder.spec == spec and len(gen.audio_encoder.encoder.layers) == 24
    assert (spec.hidden_size, spec.num_attention_heads, spec.intermediate_size, spec.conv_dim,
            spec.num_buckets, spec.max_bucket_distance, spec.conv_bias) == \
        (1024, 16, 4096, (512,) * 7, 320, 800, False)
    names = {"parametrizations.weight.original0": "weight_g",
             "parametrizations.weight.original1": "weight_v"}
    theirs = {}
    for k, v in hm.state_dict().items():
        for a, b in names.items():
            k = k.replace(a, b)
        if k != "masked_spec_embed":
            theirs["audio_encoder." + k] = tuple(v.shape)
    ours = {k: tuple(v.shape) for k, v in gen.state_dict().items()
            if k.startswith("audio_encoder.")}
    assert ours == theirs
    assert sum(math.prod(s) for s in ours.values()) == 315_452_096
    assert sorted(gen.state_dict()) == sorted(
        n for n, _, _ in bench_model.leaves(bench_model.port_keys(cfg)))
