"""The reader ``serve.graph_replay_share`` on rows made by hand: the share of
the window's ``serve.forward`` spans that hold a ``serve.replay``, and nothing
where no call opens in the window or the port has no graphed serving route."""

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


def _row(rec, name, start, parent=-1, captured=False):
    rec.rows.append([name, start, start + 500, len(rec.rows)])
    rec.parents.append(parent)
    rec.captured.append(captured)
    rec.device_ns.append(None)


def _call(rec, start, replayed, captured=False):
    """A ``serve.forward`` span at ``start``, with a ``serve.replay`` span
    inside it where ``replayed``, else the eager forward's ``mel``."""
    _row(rec, "serve.forward", start, captured=captured)
    _row(rec, "serve.replay" if replayed else "mel", start + 5, parent=len(rec.rows) - 1,
         captured=captured)


def test_graph_replay_share_is_100_where_every_call_replays(recorder):
    read = _reader("serve.graph_replay_share")
    ctx = {"t0": 10_000_000, "t1": 20_000_000}
    _call(recorder, 9_000_000, replayed=False)  # before the window: eager
    _call(recorder, 9_500_000, replayed=False, captured=True)  # a capture's forward
    for start in range(10_000_000, 20_000_000, 2_000_000):
        _call(recorder, start, replayed=True)
    _call(recorder, 20_000_000, replayed=False)  # at the window's end
    assert read(ctx) == 100.0


def test_graph_replay_share_counts_the_calls_that_replay(recorder):
    read = _reader("serve.graph_replay_share")
    ctx = {"t0": 10_000_000, "t1": 20_000_000}
    _call(recorder, 9_000_000, replayed=True)  # outside the window
    _call(recorder, 10_000_000, replayed=False)
    _call(recorder, 11_000_000, replayed=False, captured=True)  # not a call
    _call(recorder, 12_000_000, replayed=True)
    _call(recorder, 14_000_000, replayed=True)
    _call(recorder, 16_000_000, replayed=False)
    _row(recorder, "serve.replay", 17_000_000)  # no serve.forward around it
    _call(recorder, 21_000_000, replayed=True)  # outside the window
    assert read(ctx) == pytest.approx(100.0 * 2 / 4)


def test_graph_replay_share_reads_nothing_without_a_call_in_the_window(recorder):
    read = _reader("serve.graph_replay_share")
    assert read({"t0": 0, "t1": 1 << 62}) is None
    _call(recorder, 5, replayed=True)
    _call(recorder, 50, replayed=False, captured=True)
    _row(recorder, "forward", 60)
    assert read({"t0": 10, "t1": 1 << 62}) is None


def test_graph_replay_share_reads_nothing_from_a_program_without_graphs(recorder, monkeypatch):
    """A checkout whose serving function has no graphed route (no
    ``serving.ServingFn``): no value, though its eager calls open
    ``serve.forward`` spans."""
    from speechdrivestemplates_tpu_torch import serving

    _call(recorder, 5, replayed=False)
    monkeypatch.delattr(serving, "ServingFn")
    assert _reader("serve.graph_replay_share")({"t0": 0, "t1": 1 << 62}) is None


def test_spec_lists_the_replay_share_for_the_serve_cells():
    entry = next(m for m in spec.load(os.path.dirname(spec.HERE))["per_layer"]
                 if m["name"] == "serve.graph_replay_share")
    assert entry["workloads"] == ["sdt_bp.serve_b128", "s2g_gan.serve_b128"]
    assert entry["source"] == "program_span" and entry["moves"] == "serve_pose_frames_per_s"
    assert entry["layer"] == "serving forward, host" and entry["unit"] == "%"
