"""The ``sdt_hubert`` configuration's counts, readers and check: the counts
at HuBERT Large's published widths against the numbers worked out by hand;
the two roofline readers on synthetic kernel rows; on the CPU at a tiny size
(every width of the encoder cut, SDT's head kept) a run through the harness
is ``correct``, the control (the reference in fp8) fails the cell's limits,
and so does an answer altered where the port produces it."""

import copy
import importlib.util
import json
import os

import pytest

from benchmark import correct, counts, drivers, run, spec, tracing
from benchmark.counts import speech_encoder as S

ROOT = os.path.dirname(spec.HERE)
CELL = "sdt_hubert.serve_b128"
SEED = 2 ** 33 + 13
with open(os.path.join(spec.HERE, "configs", "sdt_hubert.json")) as _f:
    CONF = json.load(_f)
M = CONF["model"]
L = M["audio_length"]
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=[32] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def reader(name):
    loader = importlib.util.spec_from_file_location(name, spec.metric_path(name))
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def test_counts_at_the_published_widths():
    """213 frames a clip; a clip's encoder 157.84 GFLOP (the conv stack 20.93,
    the projection 0.22, the positional convolution 3.57, the 24 layers'
    linear maps 128.65, attention 4.46), within 0.1 of the 157.9 worked out
    by hand; the configuration carries the whole forward's count."""
    t = S.frames(M, L)
    assert t == 213
    conv = 2 * sum(S.conv_macs(M, L))
    assert conv == 2 * (13652 * 512 * 10 + 6825 * 512 * 512 * 3 + 3412 * 512 * 512 * 3
                        + 1705 * 512 * 512 * 3 + 852 * 512 * 512 * 3 + 426 * 512 * 512 * 2
                        + 213 * 512 * 512 * 2)
    linear = S.layer_linear_flops(M, L)
    assert linear == 24 * 2 * 213 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    attn = S.attention_count(M, 1, L)[0]
    assert attn == 24 * 4 * 213 ** 2 * 1024
    enc = S.encoder_flops(M, L)
    assert enc == conv + 2 * 213 * 512 * 1024 + 2 * 213 * 1024 * 64 * 128 + linear + attn
    assert (round(conv / 1e9, 1), round(linear / 1e9, 1), round(attn / 1e9, 2)) == \
        (20.9, 128.6, 4.46)
    assert abs(enc / 1e9 - 157.9) < 0.1
    assert CONF["flops"]["forward_per_clip"] == S.forward_flops(M, L)
    assert CONF["flops"]["encoder_per_clip"] == enc


def test_the_linear_and_attention_bounds_at_the_cell():
    """At B = 128 the GEMMs are bound by operations (16.7 ms at the bf16
    peak), attention by bytes (Q, K, V and O once: 1.6 ms)."""
    flops, nbytes = S.linear_count(M, 128, L)
    assert flops >= 128 * S.layer_linear_flops(M, L)
    assert counts.bound_s(flops, nbytes) == flops / counts.PEAKS["H100_SXM"]["bf16_flops_per_s"]
    assert round(counts.bound_s(flops, nbytes) * 1e3, 1) == 16.7
    flops, nbytes = S.attention_count(M, 128, L)
    assert nbytes == 24 * 4 * 2 * 128 * 213 * 1024
    assert round(counts.bound_s(flops, nbytes) * 1e3, 1) == 1.6


ROWS = {"nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT": (0.6, 240),
        "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x64_64x3_tn_align2>"
        "(cutlass_80_tensorop_bf16_s16816gemm_bf16_128x64_64x3_tn_align2::Params)": (0.1, 10),
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x256x64"
        "_warpgroupsize2x1x1_g1_execute_segment_k_off_kernel__5x_cudnn": (5.0, 20),
        "sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize64x32x8_stage3_warpsize2x2x1_ffma"
        "_aligna8_alignc8_execute_kernel__5x_cublas": (5.0, 5),
        "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 128, 4, false, "
        "false, cutlass::bfloat16_t, Flash_kernel_traits<64, 128, 128, 4, cutlass::bfloat16_t> "
        ">, false, false, false, false, false, true, false, false>(pytorch_flash::"
        "Flash_fwd_params)": (0.04, 120)}


def _ctx(rows, config=CONF):
    return {"config": config, "rows": rows,
            "work": {"calls": 5, "clips": 640, "batch": 128, "samples": L}}


def test_readers_on_synthetic_rows():
    """The linear reader sums the bf16 GEMM rows (cuBLAS's nvjet and CUTLASS
    kernels), not cuDNN's convolutions nor the complex float32 GEMM; the
    attention reader the flash kernel's rows; each is the bound over the
    seconds a call, in %. Without such rows, or for a configuration without a
    speech encoder, each gives None."""
    lin, att = reader("serve.linear_roofline"), reader("serve.attn_roofline")
    bound = counts.bound_s(*S.linear_count(M, 128, L))
    assert lin(_ctx(ROWS)) == pytest.approx(100 * bound / (0.7 / 5))
    bound = counts.bound_s(*S.attention_count(M, 128, L))
    assert att(_ctx(ROWS)) == pytest.approx(100 * bound / (0.04 / 5))
    others = {k: v for k, v in ROWS.items() if "cudnn" in k or "cf32" in k}
    assert lin(_ctx(others)) is None and att(_ctx(others)) is None
    assert lin(_ctx({})) is None and att(_ctx({})) is None
    with open(os.path.join(spec.HERE, "configs", "sdt_bp.json")) as f:
        cnn = json.load(f)
    assert lin(_ctx(ROWS, cnn)) is None and att(_ctx(ROWS, cnn)) is None


def test_the_spec_lists_the_cell_and_its_metrics():
    s = spec.load(ROOT)
    cell = spec.cell(s, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "serve_b128"
    assert [m["name"] for m in cell["end_to_end"]] == ["serve_pose_frames_per_s", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == [
        "serve.mfu", "serve.idle_share", "serve.host_lead_ms", "serve.graph_replay_share",
        "serve.linear_roofline", "serve.attn_roofline"]
    for name in ("serve.linear_roofline", "serve.attn_roofline"):
        entry = next(m for m in s["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL] and entry["unit"] == "%"


@pytest.fixture
def tiny_cell(small_cell, monkeypatch):
    """The cell at 2 clips of 6,400 samples, the encoder at the tiny widths
    (the port's table of the generator swapped for them)."""
    from speechdrivestemplates_tpu_torch import models
    from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

    spec_ = SE.SpeechEncoderSpec(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in TINY.items()})
    monkeypatch.setitem(models.MODELS, "SequenceGeneratorHuBERT",
                        type("TinyHuBERT", (SE.SequenceGeneratorHuBERT,), {"SPEC": spec_}))
    cell = copy.deepcopy(small_cell(CELL))
    cell["traffic_file"]["samples"] = 6400
    cell["config_file"]["model"].update(TINY)
    return cell


def test_the_program_passes_and_the_control_fails(tiny_cell):
    """bf16 on the CPU through ``build_serving_fn``: ``correct``; the
    reference in fp8 in the program's place fails the cell's limits."""
    out = run.run(tiny_cell, SEED, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    d = drivers.make(tiny_cell, SEED, "cpu", tracing.Spans())
    d.setup()
    d.window(0.1, tracing.Window(False, "cpu"))
    ok, rows = correct.judge(d.check(True), tiny_cell["limits"])
    assert not ok, rows


def test_an_altered_answer_fails(tiny_cell, monkeypatch):
    """Clip 0's poses in reverse time, where the serving module produces them."""
    from speechdrivestemplates_tpu_torch import serving

    forward = serving.ServingModule.forward

    def flipped(self, *a):
        out = forward(self, *a).clone()
        out[0] = out[0].flip(0)
        return out

    monkeypatch.setattr(serving.ServingModule, "forward", flipped)
    assert not run.run(tiny_cell, SEED, 0.3, False, "cpu")["correct"]
