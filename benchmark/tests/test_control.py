"""The comparison that decides ``correct`` fails what it must, on the CPU at a
size a test run holds (every width kept, small batches): the control (the
reference in fp8 in the program's place) fails each cell's limits, and a run
driven through the harness with the timed path broken underneath comes out
not correct, once for each fault its cell can have. On the card the same
readings are taken at the cells' own sizes by ``benchmark/calibrate.py``."""

import pytest
import torch

from benchmark import correct, drivers, run, tracing

SEED = 2 ** 33 + 11


def readings(cell, control):
    d = drivers.make(cell, SEED, "cpu", tracing.Spans())
    d.setup()
    d.window(0.2, tracing.Window(False, "cpu"))
    return correct.judge(d.check(control), cell["limits"])


@pytest.mark.parametrize("name", ["sdt_bp.serve_b128", "s2g_gan.serve_b128",
                                  "sdt_bp.train_b32_k8", "sdt_bp.demo_b1"])
def test_the_program_passes_and_the_control_fails(small_cell, name):
    cell = small_cell(name)
    ok, rows = readings(cell, control=False)
    assert ok, rows
    ok, rows = readings(cell, control=True)
    assert not ok, rows


def flip_clip0(poses: torch.Tensor) -> torch.Tensor:
    """An answer altered where it is produced: clip 0's poses in reverse time."""
    out = poses.clone()
    out[0] = out[0].flip(0)
    return out


def run_broken(cell):
    return run.run(cell, SEED, 0.3, False, "cpu")


def test_serve_answer_altered(small_cell, monkeypatch):
    from speechdrivestemplates_tpu_torch import serving

    forward = serving.ServingModule.forward
    monkeypatch.setattr(serving.ServingModule, "forward",
                        lambda self, *a: flip_clip0(forward(self, *a)))
    assert not run_broken(small_cell("sdt_bp.serve_b128"))["correct"]


def test_demo_answer_altered(small_cell, monkeypatch):
    from speechdrivestemplates_tpu_torch.pipelines import voice2pose

    demo_step = voice2pose.demo_step

    def broken(*a, **k):
        out = demo_step(*a, **k)
        out["poses_pred_batch"] = flip_clip0(out["poses_pred_batch"])
        return out

    monkeypatch.setattr(voice2pose, "demo_step", broken)
    assert not run_broken(small_cell("sdt_bp.demo_b1"))["correct"]


def test_train_state_unchanged(small_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = run_broken(small_cell("sdt_bp.train_b32_k8"))
    assert not out["correct"] and out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(small_cell, monkeypatch):
    from speechdrivestemplates_tpu_torch.pipelines import graphed

    gather = graphed.gather
    monkeypatch.setattr(graphed, "gather", lambda cache, idx: gather(cache, idx[: len(idx) // 2]))
    assert not run_broken(small_cell("sdt_bp.train_b32_k8"))["correct"]
