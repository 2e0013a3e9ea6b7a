"""The count of the speech encoder's feature-encoder norm and the reader
``serve.ln_gelu_roofline`` on rows made by hand: the kernel's own rows by
name, nothing from a program without the kernel or from a configuration
without a feature encoder, and no share above 100% on rows timed at the
bound."""

import importlib.util
import math
import os

import pytest

from benchmark import counts, spec
from benchmark.counts import ln_gelu

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, L = 128, 68267  # the serving cells' batch and samples
CELL = "sdt_hubert.serve_b128"
ROW = ("void (anonymous namespace)::ln_gelu_kernel<__nv_bfloat16, 2>(__nv_bfloat16 const*, "
       "__nv_bfloat16*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
       "(anonymous namespace)::Params)")


def _read(ctx):
    path = spec.metric_path("serve.ln_gelu_roofline")
    loader = importlib.util.spec_from_file_location("reader_ln_gelu", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read(ctx)


def _ctx(rows, calls=160, cell=CELL):
    conf = spec.cell(spec.load(ROOT), cell)["config_file"]
    return {"config": conf, "rows": rows,
            "work": {"calls": calls, "clips": calls * B, "batch": B, "samples": L}}


def test_ln_gelu_count_at_the_serving_shape():
    """HuBERT Large's seven feature-encoder outputs at 68,267 samples: T =
    13,652 down to 213 frames of 512 channels, 1,775,042,560 elements at B =
    128, read and written once in bf16 (7,100,170,240 bytes) plus 7 x 3 x 512
    bf16 parameters (21,504): 7,100,191,744 bytes, bound by bytes at 2.1195
    ms."""
    m = spec.cell(spec.load(ROOT), CELL)["config_file"]["model"]
    frames = (13652, 6825, 3412, 1705, 852, 426, 213)
    assert ln_gelu.layer_sizes(m, L) == [(512, t * 512) for t in frames]
    flops, nbytes = ln_gelu.count(m, B, L)
    assert B * sum(frames) * 512 == 1_775_042_560 == flops / 2
    assert nbytes == 4 * 1_775_042_560 + 21_504 == 7_100_191_744
    assert math.isclose(counts.bound_s(flops, nbytes), nbytes / 3.35e12)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 2.1195
    _, fp32 = ln_gelu.count(m, B, L, elem=4)
    assert fp32 == 2 * nbytes


def test_reader_sums_the_kernels_rows_over_the_calls():
    """The kernel's rows (any instantiation) summed, over the calls; the plain
    LayerNorm, GELU and bias-add rows and the IN kernel's left out."""
    rows = {ROW: [0.40, 1120], ROW.replace(", 2>", ", 1>"): [0.02, 7],
            "void (anonymous namespace)::in_act_kernel<__nv_bfloat16, 8>(...)": [0.3, 2560],
            "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<...>(...)":
                [1.7, 9000],
            "void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl"
            "(...)>(...)": [1.1, 9000]}
    _, nbytes = ln_gelu.count(spec.cell(spec.load(ROOT), CELL)["config_file"]["model"], B, L)
    want = 100.0 * (nbytes / 3.35e12) / (0.42 / 160)
    assert _read(_ctx(rows)) == pytest.approx(want)
    assert 80 < want < 81


def test_reader_gives_nothing_without_the_kernel_or_a_feature_encoder():
    """The parent runs the plain passes: no row of the kernel, so no value; nor
    where no call fell in the window, nor on the CNN configurations, which have
    no ``conv_dim``."""
    plain = {"void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<...>(...)":
             [1.7, 9000], "void at::native::elementwise_kernel<128, 4, ...>(...)": [0.93, 1141]}
    assert _read(_ctx(plain)) is None
    assert _read(_ctx({ROW: [0.4, 1127]}, calls=0)) is None
    for cell in ("sdt_bp.serve_b128", "s2g_gan.serve_b128"):
        assert _read(_ctx({ROW: [0.4, 1127]}, cell=cell)) is None


def test_reader_stays_at_or_under_100_on_rows_timed_at_the_bound():
    """Rows whose time a call is the bound read 100%, within round-off, and
    slower rows less: the count holds no byte twice."""
    m = spec.cell(spec.load(ROOT), CELL)["config_file"]["model"]
    bound = counts.bound_s(*ln_gelu.count(m, B, L))
    calls = 160
    at_bound = _read(_ctx({ROW: [bound * calls, 7 * calls]}, calls))
    assert at_bound == pytest.approx(100.0) and at_bound <= 100.0 + 1e-9
    assert _read(_ctx({ROW: [1.25 * bound * calls, 7 * calls]}, calls)) == pytest.approx(80.0)


def test_spec_lists_the_ln_gelu_roofline_for_the_sdt_hubert_serve_cell():
    """The metric's entry and its cell; later cells may join its list."""
    entry = next(m for m in spec.load(ROOT)["per_layer"] if m["name"] == "serve.ln_gelu_roofline")
    assert CELL in entry["workloads"]
    assert {k: entry[k] for k in ("unit", "better", "source", "layer", "moves")} == {
        "unit": "%", "better": "higher", "source": "device_trace",
        "layer": "speech encoder feature-norm kernel", "moves": "serve_pose_frames_per_s"}
