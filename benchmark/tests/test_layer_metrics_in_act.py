"""The count of the eval IN apply and the reader ``serve.in_act_roofline`` on
rows made by hand: the kernel's own rows by name, and nothing from a program
without the kernel."""

import importlib.util
import math
import os

import pytest

from benchmark import counts, spec
from benchmark.counts import in_act

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, L, W = 128, 68267, 427  # the serving cells' batch, samples, mel frames
ROW = ("void (anonymous namespace)::in_act_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
       "__nv_bfloat16*, (anonymous namespace)::Params)")


def _read(ctx):
    path = spec.metric_path("serve.in_act_roofline")
    loader = importlib.util.spec_from_file_location("reader_in_act", path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read(ctx)


def _ctx(rows, calls=500):
    cell = spec.cell(spec.load(ROOT), "sdt_bp.serve_b128")
    return {"config": cell["config_file"], "rows": rows,
            "work": {"calls": calls, "clips": calls * B, "batch": B, "samples": L}}


def test_in_act_count_at_the_serving_shape():
    """Layers 3-7 of the audio encoder and the 16 1-D layers: 1,296,640
    elements a clip, 165,969,920 at B = 128, 663,879,680 bytes in bf16, bound
    by bytes at 0.1982 ms."""
    sizes = in_act.layer_sizes(W, 64)
    enc = [128 * 20 * 106, 256 * 20 * 106, 256 * 10 * 53, 256 * 10 * 53, 256 * 5 * 51]
    one_d = [256 * t for t in (64, 64, 32, 16, 8, 4, 2, 4, 8, 16, 32, 64, 64, 64, 64, 64)]
    assert [n for _, n in sizes] == enc + one_d and len(sizes) == 21
    assert sum(enc) == 1_150_720 and sum(one_d) == 145_920
    flops, nbytes = in_act.count(B, W)
    assert B * sum(enc + one_d) == 165_969_920 == flops / 2
    assert nbytes == 2 * 2 * 165_969_920 == 663_879_680
    assert math.isclose(counts.bound_s(flops, nbytes), nbytes / 3.35e12)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.1982


def test_reader_sums_the_kernels_rows_over_the_calls():
    """The kernel's rows (both instantiations) summed, over the calls; the
    plain passes' and the BN kernel's rows left out."""
    rows = {ROW: [0.12, 10_000], ROW.replace("8>", "1>"): [0.03, 500],
            "void (anonymous namespace)::bn_act_kernel<__nv_bfloat16, 8>(...)": [9.0, 500],
            "void at::native::reduce_kernel<128, 4, ...>(...)": [4.0, 900]}
    _, nbytes = in_act.count(B, W)
    want = 100.0 * (nbytes / 3.35e12) / (0.15 / 500)
    assert _read(_ctx(rows)) == pytest.approx(want)
    assert 60 < want < 70


def test_reader_gives_nothing_without_the_kernel():
    """The parent runs the plain passes: no row of the kernel, so no value;
    nor where no call fell in the window."""
    plain = {"void at::native::reduce_kernel<128, 4, ...>(...)": [1.0, 900],
             "void (anonymous namespace)::stem_kernel(...)": [1.8, 536]}
    assert _read(_ctx(plain)) is None
    assert _read(_ctx({ROW: [0.5, 12_000]}, calls=0)) is None


def test_spec_lists_the_in_act_roofline_for_the_sdt_bp_serve_cell():
    entry = next(m for m in spec.load(ROOT)["per_layer"] if m["name"] == "serve.in_act_roofline")
    assert entry == {"name": "serve.in_act_roofline", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "eval IN apply kernel",
                     "moves": "serve_pose_frames_per_s", "workloads": ["sdt_bp.serve_b128"]}
