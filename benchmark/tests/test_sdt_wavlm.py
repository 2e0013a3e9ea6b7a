"""The ``sdt_wavlm`` configuration's numbers, counts, reader and check: the
configuration held to the port's table and tree; the counts at the cell's
shape against the numbers worked out by hand; the gated-bias attention's
reader on synthetic kernel rows; on the CPU at a tiny size (every width of
the encoder cut, 16 buckets up to 12 frames, SDT's head kept) a run through
the harness is ``correct``, the control fails the cell's limits, and each of
the model module's faults moves the answer."""

import copy
import importlib.util
import json
import os

import pytest

from benchmark import correct, counts, drivers, run, spec, tracing
from benchmark.counts import speech_encoder as S
from benchmark.counts import wavlm as W
from benchmark.models import sdt_wavlm

ROOT = os.path.dirname(spec.HERE)
CELL = "sdt_wavlm.serve_b32_17s"
SEED = 2 ** 33 + 29
with open(os.path.join(spec.HERE, "configs", "sdt_wavlm.json")) as _f:
    CONF = json.load(_f)
M = CONF["model"]
L = M["audio_length"]
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=[32] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            num_buckets=16, max_bucket_distance=12)


def reader(name):
    loader = importlib.util.spec_from_file_location(name, spec.metric_path(name))
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def test_the_configuration_is_the_ports_table_and_tree():
    """The configuration's numbers are the port's: the preset's tree with the
    window's overrides, read as ``main.py`` reads it, and WavLM Large's table
    (the widths, ``conv_bias`` false, 320 buckets up to 800 frames); nothing
    is cut."""
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

    cfg = drivers.port_config(CONF, sdt_wavlm)
    assert cfg.VOICE2POSE.GENERATOR.NAME == "SequenceGeneratorWavLM"
    assert (cfg.DATASET.NUM_FRAMES, cfg.DATASET.AUDIO_LENGTH) == (256, 273067)
    assert {k: M[k] for k in sdt_wavlm.WIDTHS} == {
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in ((k, getattr(SE.WAVLM_LARGE, k)) for k in sdt_wavlm.WIDTHS)}
    assert (M["conv_bias"], M["num_buckets"], M["max_bucket_distance"]) == (False, 320, 800)
    assert CONF["reduced"] == []


def test_counts_at_the_cell():
    """853 frames a 273,067-sample window; a call's attention 2.2889 TFLOP
    (24 x 4 x 32 x 853^2 x 1024) and Q, K, V, O once, 5.37 GB, bound by
    operations at 2.31 ms; the bias is not counted; a clip's forward is
    ``speech_encoder``'s count plus the gates' 24 x 853 x 1024 x 16."""
    assert W.frames(M, L) == 853
    flops, nbytes = W.attention_count(M, 32, L)
    assert flops == 24 * 4 * 32 * 853 ** 2 * 1024 and round(flops / 1e12, 4) == 2.2889
    assert nbytes == 24 * 4 * 2 * 32 * 853 * 1024
    assert round(counts.bound_s(flops, nbytes) * 1e3, 2) == 2.31
    assert W.gate_flops(M, L) == 2 * 24 * 853 * 1024 * 8
    assert CONF["flops"]["forward_per_clip"] == S.forward_flops(M, L) + W.gate_flops(M, L)
    assert CONF["flops"]["encoder_per_clip"] == S.encoder_flops(M, L) + W.gate_flops(M, L)


CUDNN = ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_"
         "cga1x1x1_kernel0_0")
ROWS = {CUDNN: (0.2, 240),
        "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 128, 4, false, "
        "false, cutlass::bfloat16_t, Flash_kernel_traits<64, 128, 128, 4, cutlass::bfloat16_t> "
        ">, false, false, false, false, false, true, false, false>(pytorch_flash::"
        "Flash_fwd_params)": (0.04, 120),
        "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::native::"
        "BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, at::native::binary_internal"
        "::MulFunctor<float> > >(at::TensorIteratorBase&, ...)": (0.3, 240)}


def _ctx(rows, config=CONF):
    return {"config": config, "rows": rows,
            "work": {"calls": 10, "clips": 320, "batch": 32, "samples": L}}


def test_the_relpos_attention_reader_on_synthetic_rows():
    """The reader sums cuDNN's attention rows (not flash's, not the
    elementwise product that builds the bias): the
    bound over the seconds a call, in %. Without such rows, or for a
    configuration without a relative-position bias (SDT-HuBERT, SDT-BP), it
    gives None."""
    read = reader("serve.relpos_attn_roofline")
    bound = counts.bound_s(*W.attention_count(M, 32, L))
    assert read(_ctx(ROWS)) == pytest.approx(100 * bound / (0.2 / 10))
    assert read(_ctx({CUDNN: (0.4, 480)})) == pytest.approx(100 * bound / (0.4 / 10))
    assert read(_ctx({k: v for k, v in ROWS.items() if k != CUDNN})) is None
    assert read(_ctx({})) is None
    for other in ("sdt_hubert", "sdt_bp"):
        with open(os.path.join(spec.HERE, "configs", f"{other}.json")) as f:
            assert read(_ctx(ROWS, json.load(f))) is None


def _tiny(small_cell, monkeypatch, precision=None):
    """The cell at 2 windows of 6,400 samples (19 encoder frames), the encoder
    at the tiny widths (the port's table of the generator swapped for them)."""
    from speechdrivestemplates_tpu_torch import models
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

    spec_ = SE.SpeechEncoderSpec(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in dict(TINY, conv_bias=False).items()})
    monkeypatch.setitem(models.MODELS, "SequenceGeneratorWavLM",
                        type("TinyWavLM", (SE.SequenceGeneratorWavLM,), {"SPEC": spec_}))
    cell = copy.deepcopy(small_cell(CELL, precision))
    cell["traffic_file"]["samples"] = 6400
    cell["config_file"]["model"].update(TINY)
    return cell


@pytest.fixture
def tiny_cell(small_cell, monkeypatch):
    return _tiny(small_cell, monkeypatch)


def _pose_err(cell):
    d = drivers.make(cell, SEED, "cpu", tracing.Spans())
    d.setup()
    d.window(0.1, tracing.Window(False, "cpu"))
    return d, dict(d.check(False))["pose_err"]


def test_the_program_passes_and_the_control_fails(tiny_cell):
    """bf16 on the CPU through ``build_serving_fn``: ``correct``; the
    reference in fp8 in the program's place fails the cell's limits."""
    out = run.run(tiny_cell, SEED, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    d, _ = _pose_err(tiny_cell)
    ok, rows = correct.judge(d.check(True), tiny_cell["limits"])
    assert not ok, rows


def test_each_fault_moves_the_answer(small_cell, monkeypatch):
    """In float32, where the program's own ``pose_err`` is round-off, each
    fault of ``FAULTS`` (the bias dropped, the gate at its mean over the
    queries, the log-spaced buckets one too far) puts the tiny cell's
    ``pose_err`` over 1e-3, and is undone on exit. (At this size, 2 layers
    over 19 frames, the gate's fault is under bf16's own error: the cell's
    limits are held to the faults on the card, at the cell's size.)"""
    cell = _tiny(small_cell, monkeypatch, "fp32")
    _, clean = _pose_err(cell)
    for name, fault in sdt_wavlm.FAULTS.items():
        with fault():
            _, err = _pose_err(cell)
        print(f"{name}: pose_err {err:.3e} (program {clean:.3e})")
        assert err > 1e-3, (name, err, clean)
    # round-off again once each fault is undone (the CPU's float32 sums vary by
    # ~1e-7 between runs, so not bit for bit)
    assert clean < 1e-5 and _pose_err(cell)[1] < 1e-5
