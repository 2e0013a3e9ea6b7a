"""The port's spans (``utils/trace.py``): off without a profiler session, the
serving forward's sections in order under one, the rows on the benchmark's
clock, the cap, and the SYS.PROFILE trace's row of spans.

The ``gpu`` cases (device markers, a capture with tracing on, the device rows
of a CUDA-only session) skip without a card. On a machine with one (and
without JAX, which tests/conftest.py imports), run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_trace.py
"""

import collections
import glob
import json
import os
import time

import pytest
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile

from speechdrivestemplates_tpu_torch.config import apply_overrides, s2g, sdt_bp
from speechdrivestemplates_tpu_torch.models import build_model
from speechdrivestemplates_tpu_torch.serving import ServingModule
from speechdrivestemplates_tpu_torch.utils import trace

SECTIONS = ["mel", "encoder.stem", "encoder.layers", "unet", "decoder", "final"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def _serving(preset, device="cpu"):
    cfg = preset(precision="fp32")
    model = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device=device)
    module = ServingModule(cfg, model.state_dict(), device)
    gen = torch.Generator().manual_seed(1)
    audio = (0.1 * torch.randn(2, cfg.DATASET.AUDIO_LENGTH, generator=gen)).to(device)
    code = torch.randn(2, 32, generator=gen).to(device) if module.has_code else None
    return module, audio, code


def _sections(preset):
    return [s for s in SECTIONS if preset is sdt_bp or s != "encoder.stem"]


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not profiler._is_profiler_enabled
    ctx = trace.span("a")
    assert ctx is trace.span("b") is trace._OFF
    with ctx:
        pass
    module, audio, code = _serving(sdt_bp)
    with torch.inference_mode():
        module(audio, code)
    rec = trace.RECORDER
    assert rec.rows == [] and rec.parents == [] and rec.pool == [] and rec.anchor is None


def test_the_flag_follows_the_profiler_session():
    assert not profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled
        with trace.span("x"):
            pass
    assert not profiler._is_profiler_enabled
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()  # the trainer's SYS.PROFILE window opens and closes so
    try:
        assert profiler._is_profiler_enabled
    finally:
        prof.stop()
    assert not profiler._is_profiler_enabled
    with trace.span("y"):
        pass
    assert [r[0] for r in trace.RECORDER.rows] == ["x"]


@pytest.mark.parametrize("preset", [sdt_bp, s2g], ids=["sdt_bp", "s2g"])
def test_serving_forward_sections_nest_in_order(preset):
    """One call gives ``serve.forward`` and its sections, in order, each
    inside it and after the one before, with one request id; a BN encoder
    (s2g) has no stem section. The poses are those of an untraced call, bit
    for bit."""
    module, audio, code = _serving(preset)
    with torch.inference_mode():
        off = module(audio, code)
        with profile(activities=[ProfilerActivity.CPU]):
            on = module(audio, code)
    assert torch.equal(on, off)
    rec = trace.RECORDER
    names = [r[0] for r in rec.rows]
    assert names == ["serve.forward"] + _sections(preset)
    (_, f0, f1, req), sections = rec.rows[0], rec.rows[1:]
    assert req == 0 and rec.parents == [-1] + [0] * len(sections)
    assert not any(rec.captured) and rec.device_ns == [None] * len(rec.rows)
    prev_end = f0
    for name, a, b, r in sections:
        assert r == req and prev_end <= a <= b <= f1, name
        prev_end = b
    assert rec.dropped == 0 and rec.open == []


def test_train_step_losses_are_bit_identical_with_tracing_on():
    """An SDT-BP train step from a fresh state under a CPU session gives the
    losses of one without, bit for bit, and carries the generator's sections
    (no ``final``: the train step has no serving output)."""
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                      train_step)
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch

    cfg = apply_overrides(sdt_bp(precision="fp32"), ["TRAIN.BATCH_SIZE", "2"])
    batch = train_batch(cfg, 2, 4, "cpu", seed=3)

    def step():
        return train_step(Voice2PoseTrainState(cfg, 4, "cpu"), batch)[0]

    off = step()
    with profile(activities=[ProfilerActivity.CPU]):
        on = step()
    assert off.keys() == on.keys() and all(torch.equal(off[k], on[k]) for k in off)
    assert [r[0] for r in trace.RECORDER.rows] == SECTIONS[:-1]


def test_requests_count_outermost_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.span("outer"):
                with trace.span("inner"):
                    pass
    rec = trace.RECORDER
    assert [r[3] for r in rec.rows] == [0, 0, 1, 1, 2, 2]
    assert rec.parents == [-1, 0, -1, 2, -1, 4]


def test_rows_share_the_benchmarks_clock():
    """Rows are on ``perf_counter_ns``; with ``unix_offset_ns`` they land on
    the Unix clock within 1 ms, as ``benchmark/tracing.py::Spans`` rows do."""
    with profile(activities=[ProfilerActivity.CPU]):
        u0 = time.time_ns()
        with trace.span("x"):
            pass
        u1 = time.time_ns()
    _, a, b, _ = trace.RECORDER.rows[0]
    off = trace.RECORDER.unix_offset_ns
    assert u0 - 1_000_000 <= a + off <= b + off <= u1 + 1_000_000


def test_the_cap_counts_dropped_spans():
    rec = trace.Recorder(cap=3)
    for _ in range(2):
        with rec.span("outer"):
            with rec.span("inner"):
                pass
    assert [r[0] for r in rec.rows] == ["outer", "inner", "outer"]
    assert rec.dropped == 1 and rec.open == []
    rec.reset()
    assert rec.rows == [] and rec.dropped == 0


def test_sys_profile_trace_holds_the_spans(tmp_path):
    """A SYS.PROFILE window over an SDT-BP training step on the CPU: the
    Chrome trace has the port's spans on a row of their own, on the trace's
    clock, and a ``mel`` span encloses each of the mel's reflect pads."""
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    root = str(tmp_path / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=4, num_dev=1, seed=5)
    cfg = apply_overrides(sdt_bp(precision="fp32"), [
        "DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", str(tmp_path / "out"),
        "TRAIN.BATCH_SIZE", "2", "TRAIN.NUM_EPOCHS", "1", "TRAIN.VALIDATE", "False",
        "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0", "SYS.PROFILE.ENABLED", "True",
        "SYS.PROFILE.START_STEP", "1", "SYS.PROFILE.NUM_STEPS", "1"])
    out = trainer.train(cfg, "prof", "cpu")
    (path,) = glob.glob(os.path.join(out["output_dir"], "profile", "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "port_span"]
    names = collections.Counter(e["name"] for e in spans)
    assert names == {"mel": 1, "encoder.stem": 1, "encoder.layers": 1, "unet": 1,
                     "decoder": 1}, names
    assert {(e["pid"], e["tid"]) for e in spans} == {(os.getpid(), trace.CHROME_TID)}
    pads = [e for e in events if e.get("name") == "aten::reflection_pad1d"]
    mels = [e for e in spans if e["name"] == "mel"]
    assert pads and all(any(m["ts"] <= p["ts"] and p["ts"] + p["dur"] <= m["ts"] + m["dur"]
                            for m in mels) for p in pads), (pads, mels)


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device markers are CUDA events")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("preset", [sdt_bp, s2g], ids=["sdt_bp", "s2g"])
def test_markers_resolve_in_order(cuda, preset):
    """Under a CUDA-only session, three calls' markers resolve: in the order
    they were recorded on the stream, none before its span's host start (less
    the anchor's few microseconds), a section's not before its parent's; the
    poses equal an untraced call's bit for bit."""
    module, audio, code = _serving(preset, cuda)
    with torch.inference_mode():
        off = module(audio, code)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]):
            outs = [module(audio, code) for _ in range(3)]
            torch.cuda.synchronize()
    trace.resolve()
    assert all(torch.equal(o, off) for o in outs)
    rec = trace.RECORDER
    per_call = 1 + len(_sections(preset))
    assert len(rec.rows) == 3 * per_call and [r[3] for r in rec.rows[::per_call]] == [0, 1, 2]
    dev = rec.device_ns
    assert None not in dev and dev == sorted(dev)
    for i, (name, a, _, _) in enumerate(rec.rows):
        assert dev[i] >= a - 50_000, (name, dev[i] - a)
        if rec.parents[i] >= 0:
            assert dev[i] >= dev[rec.parents[i]], name
    assert abs(rec.clock_ratio - 1.0) < 1e-3 and not rec.markers and rec.pool


def _run_graphed(cfg, cache, chunks):
    from speechdrivestemplates_tpu_torch.pipelines.graphed import ChunkRunner
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                      train_step)

    state = Voice2PoseTrainState(cfg, cache["clip_index"].shape[0], "cuda", capturable=True)
    runner = ChunkRunner(state, train_step, cache, graphed=True)
    rows = [runner.run(torch.tensor(c, device="cuda")) for c in chunks]
    torch.cuda.synchronize()
    return torch.cat(rows)


@pytest.mark.gpu
def test_capture_with_tracing_on_replays_bit_for_bit(cuda):
    """SDT-BP chunks through ``ChunkRunner`` (warm, captured K = 2, replayed)
    under a CUDA-only session, against the same chunks untraced: the loss rows
    agree bit for bit (cuDNN deterministic on both sides). The generator's
    sections inside the capture are flagged and carry no marker; the runner's
    own spans carry one."""
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import DEVICE_KEYS
    from speechdrivestemplates_tpu_torch.datasets.synthetic import train_batch

    cfg = apply_overrides(sdt_bp(), ["TRAIN.BATCH_SIZE", "2", "TRAIN.STEPS_PER_DISPATCH", "2"])
    batch = train_batch(cfg, 8, 8, "cuda", seed=3)
    cache = {k: batch[k] for k in DEVICE_KEYS if k in batch}
    chunks = [[[0, 1]], [[2, 3], [4, 5]], [[6, 7], [1, 0]]]
    torch.backends.cudnn.deterministic = True
    try:
        off = _run_graphed(cfg, cache, chunks)
        with profile(activities=[ProfilerActivity.CUDA]):
            on = _run_graphed(cfg, cache, chunks)
    finally:
        torch.backends.cudnn.deterministic = False
    trace.resolve()
    assert torch.equal(on, off), (on - off).abs().max()
    rec = trace.RECORDER
    top = [r[0] for r, p in zip(rec.rows, rec.parents) if p < 0]
    assert top == ["chunk.warm", "chunk.capture", "chunk.replay", "chunk.replay"]
    inner = {i for i, p in enumerate(rec.parents) if p >= 0
             and rec.rows[p][0] == "chunk.capture"}
    assert inner and all(rec.captured[i] and rec.device_ns[i] is None for i in inner)
    assert all(rec.device_ns[i] is not None for i, p in enumerate(rec.parents) if p < 0)


@pytest.mark.gpu
def test_a_cuda_only_session_gains_no_device_rows(cuda, monkeypatch):
    """The device rows a CUDA-only session records of one serving call (as
    ``benchmark/tracing.py::Window.device_events`` reads them) are the same
    names, as often, with the recorder on and forced off."""
    module, audio, code = _serving(sdt_bp, cuda)

    def device_names():
        with torch.inference_mode():
            module(audio, code)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                module(audio, code)
                torch.cuda.synchronize()
        kind = torch.autograd.DeviceType.CUDA
        return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                   if e.device_type() == kind and e.duration_ns() > 0)

    on = device_names()
    assert trace.RECORDER.rows
    monkeypatch.setattr(trace, "span", lambda name: trace._OFF)
    assert device_names() == on
