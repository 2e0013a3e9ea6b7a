"""The count of the eval BN apply and the reader ``serve.bn_act_roofline`` on
rows made by hand: the kernel's own rows by name, and nothing from a program
without the kernel."""

import importlib.util
import math
import os

import pytest

from benchmark import counts, spec
from benchmark.counts import bn_act

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, L, W = 128, 68267, 427  # the serving cells' batch, samples, mel frames
ROW = ("void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
       "__nv_bfloat16*, (anonymous namespace)::Params)")


def _read(ctx):
    path = spec.metric_path("serve.bn_act_roofline")
    loader = importlib.util.spec_from_file_location("reader_bn_act", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read(ctx)


def _ctx(rows, calls=500):
    cell = spec.cell(spec.load(ROOT), "s2g_gan.serve_b128")
    return {"config": cell["config_file"], "rows": rows,
            "work": {"calls": calls, "clips": calls * B, "batch": B, "samples": L}}


def test_bn_act_count_at_the_serving_shape():
    sizes = bn_act.layer_sizes(W, 64)
    enc = [64 * 80 * 427, 64 * 40 * 213, 128 * 40 * 213, 128 * 20 * 106, 256 * 20 * 106,
           256 * 10 * 53, 256 * 10 * 53, 256 * 5 * 51]
    one_d = [256 * t for t in (64, 64, 32, 16, 8, 4, 2, 4, 8, 16, 32, 64, 64, 64, 64, 64)]
    assert [n for _, n in sizes] == enc + one_d
    assert sum(enc) == 4_972_800 and sum(one_d) == 145_920
    flops, nbytes = bn_act.count(B, W)
    assert B * sum(enc + one_d) == 655_196_160 == flops / 2
    channels = 64 + 64 + 128 + 128 + 256 * 4 + 256 * 16
    assert nbytes == 2 * 2 * 655_196_160 + 4 * 4 * channels == 2_620_872_704
    # bound by bytes: 0.7824 ms at 3.35 TB/s
    assert math.isclose(counts.bound_s(flops, nbytes), nbytes / 3.35e12)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.7824


def test_reader_sums_the_kernels_rows_over_the_calls():
    rows = {ROW: [0.5, 12_000], ROW.replace("8>", "1>"): [0.1, 10],
            "void (anonymous namespace)::apply_kernel<__nv_bfloat16>(...)": [9.0, 500],
            "void at::native::elementwise_kernel<128, 2, ...>(...)": [4.0, 900]}
    _, nbytes = bn_act.count(B, W)
    want = 100.0 * (nbytes / 3.35e12) / (0.6 / 500)
    assert _read(_ctx(rows)) == pytest.approx(want)
    assert 60 < want < 70


def test_reader_gives_nothing_without_the_kernel():
    """The parent runs the plain passes: no row of the kernel, so no value;
    nor where no call fell in the window."""
    plain = {"void at::native::elementwise_kernel<128, 2, ...>(...)": [4.0, 900],
             "void (anonymous namespace)::mel_kernel(...)": [0.16, 536]}
    assert _read(_ctx(plain)) is None
    assert _read(_ctx({ROW: [0.5, 12_000]}, calls=0)) is None


def test_spec_lists_the_bn_act_roofline_for_the_s2g_serve_cell():
    entry = next(m for m in spec.load(ROOT)["per_layer"] if m["name"] == "serve.bn_act_roofline")
    assert entry == {"name": "serve.bn_act_roofline", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "eval BN apply kernel",
                     "moves": "serve_pose_frames_per_s", "workloads": ["s2g_gan.serve_b128"]}
