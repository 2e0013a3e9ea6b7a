"""SDT-HuBERT (``models/speech_encoder.py``) on the CPU at a tiny size:
hidden 64, 2 layers of 4 heads, inner 128, 7 x 32 conv channels at the
published kernels and strides, a positional convolution of 16 taps in 4
groups, seeded random weights (the benchmark's seeded kinds).

The benchmark's plain reference (``benchmark/reference/speech_encoder.py``)
is held to transformers' ``HubertModel`` (built here from a config, nothing
downloaded); the port's generator, its serving function and its train step
to the reference; the ``features`` hook leaves SDT-BP's and s2g's serving
as it was; the serving forward's spans. The published widths are built on
the meta device only, where their parameters are counted."""

import os

import pytest
import torch

from benchmark import weights as bench_weights
from benchmark.models import sdt_hubert as bench_model
from benchmark.reference import pose as ref_pose
from benchmark.reference import speech_encoder as ref_se
from speechdrivestemplates_tpu_torch import config, kernels, models
from speechdrivestemplates_tpu_torch.models import speech_encoder as SE
from speechdrivestemplates_tpu_torch.utils import trace

TINY = SE.SpeechEncoderSpec(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, conv_dim=(32,) * 7,
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
SAMPLES = 6400  # 19 encoder frames
# the reference's model entry at the tiny widths (the benchmark's keys)
M = {**{k: (list(v) if isinstance(v, tuple) else v) for k, v in vars(TINY).items()},
     "norm": "IN", "code_dim": 32, "leaky_slope": 0.2, "num_landmarks": 121,
     "num_frames": 64, "hierarchical_pose": True}


class TinyHuBERT(SE.SequenceGeneratorHuBERT):
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
    w = bench_weights.seeded_weights(bench_model, M, 2 ** 33 + 5, "cpu")
    g = torch.Generator().manual_seed(1)
    audio = 0.1 * torch.randn(3, SAMPLES, generator=g)
    code = torch.randn(3, 32, generator=g)
    stat = ref_pose.speaker_stat("oliver", True)
    with torch.no_grad():
        pred = ref_se.forward(w, audio, 64, code, M)
    return dict(w=w, audio=audio, code=code, pred=pred,
                poses=ref_pose.final_poses(pred, stat, True))


def _generator(w, dtype):
    gen = TinyHuBERT(121, 32, dtype=dtype).eval()
    gen.load_state_dict(bench_model.port_state_dict(w), strict=True)
    return gen


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_reference_encoder_equals_transformers_hubert(tiny):
    """transformers' ``HubertModel`` with HuBERT Large's flags, given the same
    weights (its weight-norm parametrization's ``original0`` / ``original1``
    are ``weight_g`` / ``weight_v``), returns the reference encoder's
    ``last_hidden_state`` within 1e-5 of its largest value: both are float32
    on the same operations, summed in other orders (measured 9e-7)."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    hc = transformers.HubertConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        conv_dim=(32,) * 7, conv_kernel=TINY.conv_kernel, conv_stride=TINY.conv_stride,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, layer_norm_eps=1e-5,
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        hidden_act="gelu", feat_extract_activation="gelu")
    hm = transformers.HubertModel(hc).eval()
    names = {"parametrizations.weight.original0": "weight_g",
             "parametrizations.weight.original1": "weight_v"}
    sd = {}
    for k, v in hm.state_dict().items():
        mine = k
        for a, b in names.items():
            mine = mine.replace(a, b)
        sd[k] = v if k == "masked_spec_embed" else tiny["w"]["audio_encoder." + mine]
    hm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want = hm(ref_se.normalize(tiny["audio"])).last_hidden_state
        got = ref_se.encoder(tiny["w"], tiny["audio"], M)
    assert got.shape == want.shape == (3, 19, 64)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"reference vs HubertModel: max |diff| / max |value| {err:.2e}")
    assert err < 1e-5, err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
def test_port_generator_equals_the_reference(tiny, dtype, tol):
    """The port's eval forward (the cached weights, the FFT positional
    convolution, the math attention on the CPU) against the reference's
    normalized poses, rel L2: float32 within 1e-5 (the same float32
    operations in other orders; measured 6e-7); bf16 within 3e-2, the rounding
    of every activation to 8 bits of mantissa through 2 layers, the UNet and
    the decoder (measured 8e-3)."""
    gen = _generator(tiny["w"], dtype)
    kernels.ATTENTION.clear()
    with torch.no_grad():
        got = gen(gen.features(tiny["audio"]), 64, tiny["code"])
    rel = _rel(got.float(), tiny["pred"])
    print(f"port {dtype} vs reference: rel L2 {rel:.2e}")
    assert got.dtype == dtype and got.shape == (3, 64, 2, 121) and rel < tol, rel
    assert dict(kernels.ATTENTION) == {"math": 2}


def test_serving_fn_returns_the_reference_poses(tiny, monkeypatch):
    """``build_serving_fn`` of the ``voice2pose_sdt_hubert`` preset in fp32
    (its generator picked by GENERATOR.NAME, here at the tiny widths) returns
    the reference's pixel-space poses within rel L2 1e-5, as the port's
    forward does."""
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    monkeypatch.setitem(models.MODELS, "SequenceGeneratorHuBERT", TinyHuBERT)
    cfg = config.sdt_hubert(precision="fp32")
    fn, has_code = build_serving_fn(cfg, bench_model.port_state_dict(tiny["w"]), "cpu")
    got = fn(tiny["audio"], tiny["code"])
    assert has_code and dict(fn.routes) == {"eager": 1}
    rel = _rel(got, tiny["poses"])
    assert got.shape == (3, 64, 2, 121) and rel < 1e-5, rel


def test_train_step_reaches_every_encoder_leaf(tiny, monkeypatch):
    """One fp32 train step of the preset at the tiny widths: finite losses, a
    nonzero gradient in every parameter of the encoder (the weight norm's
    ``weight_g`` and ``weight_v`` included) and of the glue, none from the
    eval cache; a later eval forward sees the stepped weights."""
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                     eval_step, train_step)

    monkeypatch.setitem(models.MODELS, "SequenceGeneratorHuBERT", TinyHuBERT)
    cfg = config.apply_overrides(config.sdt_hubert(precision="fp32"),
                                 ["TRAIN.LR_SCHEDULER", "False"])
    state = Voice2PoseTrainState(cfg, 8, "cpu")
    state.generator.load_state_dict(bench_model.port_state_dict(tiny["w"]), strict=True)
    batch = train_batch(cfg, 4, 8, "cpu")
    batch["audio"] = batch["audio"][:, :SAMPLES]
    _, before = eval_step(state, batch, fixed_code=tiny["code"][:1].expand(4, -1))
    losses, _ = train_step(state, batch)
    assert losses and all(torch.isfinite(v).all() for v in losses.values()), losses
    grads = {n: p.grad for n, p in state.generator.named_parameters()
             if n.startswith(("audio_encoder.", "audio_proj."))}
    assert len(grads) == len(bench_model.leaves(M)) - len(
        [x for x in bench_model.leaves(M) if x[0].startswith(("unet.", "decoder."))])
    zero = [n for n, g in grads.items() if g is None or not bool(g.abs().sum() > 0)]
    assert not zero, zero
    _, after = eval_step(state, batch, fixed_code=tiny["code"][:1].expand(4, -1))
    assert not torch.equal(after["poses_pred_batch"], before["poses_pred_batch"])


def test_eval_weights_are_cached_once_and_refreshed_in_place(tiny):
    """An eval forward without autograd reads one cache made at load (weight
    norm folded, Q, K, V stacked); a second load refreshes the same tensors
    in place; a parameter changed in place is seen by its version."""
    gen = _generator(tiny["w"], torch.float32)
    enc = gen.audio_encoder
    cache = enc._cache
    assert cache is not None
    with torch.no_grad():
        assert enc.weights() is cache
        pc = enc.encoder.pos_conv_embed.conv
        torch.testing.assert_close(cache[2][0], torch._weight_norm(pc.weight_v, pc.weight_g, 2))
        a = enc.encoder.layers[1].attention
        assert torch.equal(cache[3][1][2], torch.cat([a.q_proj.weight, a.k_proj.weight,
                                                      a.v_proj.weight]))
    ptrs = [t.data_ptr() for t in SE._flatten(cache)]
    other = {k: v + 0.01 for k, v in tiny["w"].items()}
    gen.load_state_dict(other, strict=True)
    assert enc._cache is cache and [t.data_ptr() for t in SE._flatten(cache)] == ptrs
    with torch.no_grad():
        torch.testing.assert_close(cache[4][0], other["audio_encoder.encoder.layer_norm.weight"])
        enc.encoder.layer_norm.weight.add_(1.0)
        assert torch.equal(enc.weights()[4][0], other["audio_encoder.encoder.layer_norm.weight"]
                           + 1.0)
    assert enc.train()._refresh() is None and enc._cache is None


def test_the_generators_own_init_is_hubert_s():
    """A built generator's encoder holds HuBERT's init in every parameter (its
    modules are made without memory of their own first): linears N(0, 0.02),
    biases 0 (the positional convolution's too), LayerNorms (1, 0),
    ``weight_g`` the norm of ``weight_v``, nothing left unset."""
    junk = [torch.full((1 << 16,), float("nan")) for _ in range(64)]
    del junk
    enc = TinyHuBERT(121, 32, generator=torch.Generator().manual_seed(4)).audio_encoder
    assert all(torch.isfinite(p).all() for p in enc.parameters())
    for name, p in enc.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
        elif "layer_norm.weight" in name:
            assert bool((p == 1).all()), name
    pc = enc.encoder.pos_conv_embed.conv
    torch.testing.assert_close(pc.weight(), pc.weight_v)
    q = enc.encoder.layers[0].attention.q_proj.weight
    assert abs(float(q.std()) - 0.02) < 0.002


@pytest.mark.parametrize("preset", ["sdt_bp", "s2g"])
def test_the_features_hook_leaves_mel_serving_as_it_was(preset):
    """``ServingModule`` of SDT-BP and s2g through ``features`` returns the
    poses of the mel, generator and final step called as before the hook,
    bit for bit, and a CNN's ``features`` is the mel."""
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.serving import ServingModule

    cfg = getattr(config, preset)(precision="fp32")
    sd = models.build_model("SequenceGeneratorCNN", cfg, device="cpu").state_dict()
    module = ServingModule(cfg, sd, "cpu")
    g = torch.Generator().manual_seed(3)
    audio = 0.1 * torch.randn(2, cfg.DATASET.AUDIO_LENGTH, generator=g)
    code = torch.randn(2, 32, generator=g) if module.has_code else None
    with torch.inference_mode():
        got = module(audio, code)
        mel = mel_spectrogram(audio)
        assert torch.equal(module.model.features(audio), mel)
        pred = module.model(mel, module.num_frames, code)
        want = get_final_results(pred, module.mean.expand(2, -1), module.std.expand(2, -1),
                                 module.scale.expand(2), module.hierarchical, module.num_kp)
    assert torch.equal(got, want)


def test_serving_spans_nest_in_order_with_no_mel(tiny, monkeypatch):
    """One traced serving call of the tiny SDT-HuBERT: ``serve.forward`` and
    inside it, in order, ``encoder.features``, ``encoder.transformer``,
    ``unet``, ``decoder`` and ``final``, each after the one before, and no
    ``mel``; the poses are those of an untraced call, bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from speechdrivestemplates_tpu_torch.serving import ServingModule

    monkeypatch.setitem(models.MODELS, "SequenceGeneratorHuBERT", TinyHuBERT)
    module = ServingModule(config.sdt_hubert(precision="fp32"),
                           bench_model.port_state_dict(tiny["w"]), "cpu")
    trace.reset()
    with torch.inference_mode():
        off = module(tiny["audio"], tiny["code"])
        with profile(activities=[ProfilerActivity.CPU]):
            on = module(tiny["audio"], tiny["code"])
    rows, parents = list(trace.RECORDER.rows), list(trace.RECORDER.parents)
    trace.reset()
    assert torch.equal(on, off)
    assert [r[0] for r in rows] == ["serve.forward", "encoder.features", "encoder.transformer",
                                    "unet", "decoder", "final"]
    assert parents == [-1] + [0] * 5
    (_, f0, f1, _), sections = rows[0], rows[1:]
    prev = f0
    for name, a, b, _ in sections:
        assert prev <= a <= b <= f1, name
        prev = b


def test_the_preset_builds_hubert_large():
    """``build_model`` of the ``voice2pose_sdt_hubert`` preset's generator
    name, built on the meta device: HuBERT Large's published widths and
    315,437,696 encoder parameters, transformers' count of ``HubertModel``
    without ``masked_spec_embed``."""
    cfg = config.sdt_hubert()
    assert cfg.VOICE2POSE.GENERATOR.NAME == "SequenceGeneratorHuBERT"
    with torch.device("meta"):
        gen = models.MODELS[cfg.VOICE2POSE.GENERATOR.NAME].from_cfg(
            cfg, models.compute_dtype(cfg))
    enc = gen.audio_encoder
    assert enc.spec == SE.HUBERT_LARGE and len(enc.encoder.layers) == 24
    layer = enc.encoder.layers[0]
    assert tuple(layer.attention.q_proj.weight.shape) == (1024, 1024)
    assert tuple(layer.feed_forward.intermediate_dense.weight.shape) == (4096, 1024)
    assert [tuple(m.conv.weight.shape) for m in enc.feature_extractor.conv_layers] == \
        [(512, 1, 10)] + [(512, 512, 3)] * 4 + [(512, 512, 2)] * 2
    assert tuple(enc.encoder.pos_conv_embed.conv.weight_v.shape) == (1024, 64, 128)
    assert SE.HUBERT_LARGE.num_attention_heads == 16
    assert sum(p.numel() for p in enc.parameters()) == 315_437_696
    assert sorted(gen.state_dict()) == sorted(
        n for n, _, _ in bench_model.leaves(bench_model.port_keys(cfg)))


def test_mel_only_paths_refuse_the_waveform_generator(tmp_path):
    """The sequence-parallel demo and the serving export split or cover a mel
    encoder: both refuse ``SequenceGeneratorHuBERT`` by its ``MEL_INPUT``,
    before any weights load."""
    import types

    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import seq_parallel_demo_forward
    from speechdrivestemplates_tpu_torch.utils.export import export_serving_fn

    cfg = config.sdt_hubert(precision="fp32")
    assert models.SequenceGeneratorCNN.MEL_INPUT and not TinyHuBERT.MEL_INPUT
    state = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"),
                                  generator=TinyHuBERT(121, 32))
    with pytest.raises(ValueError, match="mel encoder only"):
        seq_parallel_demo_forward(state, {}, 64)
    with pytest.raises(ValueError, match="mel-input generators only"):
        export_serving_fn(cfg, str(tmp_path / "absent.pth"), str(tmp_path / "out.pt2"),
                          device="cpu")
