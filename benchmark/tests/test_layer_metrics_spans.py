"""The reader of the port's spans, ``serve.host_lead_ms``, on rows made by
hand: the median lead of the ``serve.forward`` spans that open inside the
window, and nothing where no span has a marker."""

import importlib.util
import os

import pytest

from benchmark import spec


def _reader(name):
    loader = importlib.util.spec_from_file_location(f"reader_{name}", spec.metric_path(name))
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


@pytest.fixture
def recorder(monkeypatch):
    from speechdrivestemplates_tpu_torch.utils import trace

    rec = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", rec)
    return rec


def _row(rec, name, start, device=None, parent=-1):
    rec.rows.append([name, start, start + 500, len(rec.rows)])
    rec.parents.append(parent)
    rec.captured.append(False)
    rec.device_ns.append(device)


def test_host_lead_is_the_median_lead_of_the_windows_calls(recorder):
    read = _reader("serve.host_lead_ms")
    ctx = {"t0": 10_000_000, "t1": 20_000_000}
    _row(recorder, "serve.forward", 9_000_000, 9_100_000)  # before the window
    for start, lead_ns in ((10_000_000, 2_000), (12_000_000, 6_000_000),
                           (14_000_000, 4_000_000), (16_000_000, 9_000_000)):
        _row(recorder, "serve.forward", start, start + lead_ns)
        _row(recorder, "mel", start + 10, start + 1, parent=len(recorder.rows) - 1)
    _row(recorder, "serve.forward", 18_000_000)  # no marker
    _row(recorder, "serve.forward", 20_000_000, 20_000_001)  # at the window's end
    assert read(ctx) == pytest.approx((4.0 + 6.0) / 2)


def test_host_lead_reads_nothing_without_markers(recorder):
    read = _reader("serve.host_lead_ms")
    assert read({"t0": 0, "t1": 1 << 62}) is None
    _row(recorder, "serve.forward", 5)
    _row(recorder, "forward", 6, 7)
    assert read({"t0": 0, "t1": 1 << 62}) is None


def test_host_lead_reads_nothing_from_a_program_without_spans(monkeypatch):
    """A checkout whose port has no ``utils/trace.py`` (the reader's import
    fails): no value, and no error."""
    import builtins

    real = builtins.__import__

    def no_trace(name, *args, **kwargs):
        if name == "speechdrivestemplates_tpu_torch.utils" and "trace" in (args[2] or ()):
            raise ImportError("no module named trace")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert _reader("serve.host_lead_ms")({"t0": 0, "t1": 1}) is None


def test_spec_lists_the_reader_for_the_serve_cells():
    entry = next(m for m in spec.load(os.path.dirname(spec.HERE))["per_layer"]
                 if m["name"] == "serve.host_lead_ms")
    assert entry["workloads"] == ["sdt_bp.serve_b128", "s2g_gan.serve_b128"]
    assert entry["source"] == "program_span" and entry["moves"] == "serve_pose_frames_per_s"
