"""What the benchmark loads: never JAX, flax or the JAX package (top-level
module names compared whole: the port's name begins with the JAX package's);
the reference loads nothing of the port either. And the reference holds the
port's plain CPU path at a small size, in float32."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORBIDDEN = {"jax", "jaxlib", "flax", "speechdrivestemplates_tpu"}
PORT = "speechdrivestemplates_tpu_torch"


def imported_modules(paths):
    """Every module an import statement in ``paths`` names."""
    names = set()
    for path in paths:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module)
    return sorted(names)


def loaded_after(modules):
    code = ("import importlib, sys; sys.path.insert(0, %r)\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))") % (ROOT, modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def bench_files(*parts):
    return sorted(glob.glob(os.path.join(ROOT, "benchmark", *parts), recursive=True))


def test_harness_loads_no_jax():
    files = [f for f in bench_files("**", "*.py") if os.sep + "tests" + os.sep not in f]
    modules = [m for m in imported_modules(files) if not m.startswith("benchmark")]
    # every module of the harness; a metric reader's file name holds dots, so
    # its imports stand for it
    own = ["benchmark." + os.path.relpath(f, os.path.join(ROOT, "benchmark"))[:-3]
           .replace(os.sep, ".") for f in files
           if os.path.basename(f)[:-3].isidentifier() and not f.endswith("__init__.py")]
    loaded = loaded_after(modules + own)
    assert PORT in loaded  # the drivers' imports of the port were walked
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    files = bench_files("reference", "*.py")
    for m in imported_modules(files):
        assert m.split(".")[0] not in FORBIDDEN | {PORT}, m
    loaded = loaded_after(["benchmark.reference." + os.path.basename(f)[:-3]
                           for f in files if not f.endswith("__init__.py")])
    assert not loaded & (FORBIDDEN | {PORT}), loaded & (FORBIDDEN | {PORT})


def test_the_run_refuses_jax(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "speechdrivestemplates_tpu.models", sys)
    assert run.forbidden_modules() == ["speechdrivestemplates_tpu"]
    monkeypatch.delitem(sys.modules, "speechdrivestemplates_tpu.models")
    monkeypatch.setitem(sys.modules, "speechdrivestemplates_tpu_torch.x", sys)
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("name", ["sdt_bp.serve_b128", "s2g_gan.serve_b128"])
def test_reference_holds_the_ports_plain_serving_forward(small_cell, name):
    """fp32 on the CPU: the port's ``build_serving_fn`` (plain mel, plain
    stem or BN layers, plain rest) against the reference, same weights and
    inputs: they differ by float32 summation order only."""
    from benchmark import drivers, tracing

    cell = small_cell(name, precision="fp32")
    d = drivers.make(cell, 2 ** 33 + 1, "cpu", tracing.Spans())
    d.setup()
    d.window(0.2, tracing.Window(False, "cpu"))
    numbers = dict(d.check())
    assert numbers["worst_clip_pose_err"] < 1e-4, numbers


def test_reference_holds_the_ports_plain_train_steps(small_cell):
    """fp32 on the CPU: the port's first three steps through ``ChunkRunner``
    against the reference's: losses, the first gradient and the change."""
    from benchmark import drivers, tracing

    d = drivers.make(small_cell("sdt_bp.train_b32_k8", precision="fp32"), 7, "cpu",
                     tracing.Spans())
    d.setup()
    d.window(0.1, tracing.Window(False, "cpu"))
    numbers = dict(d.check())
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_diff_median"] < 1e-3, numbers
    assert numbers["update_gap"] < 1e-2 and numbers["nonfinite_losses"] == 0, numbers


def test_reference_mel_is_torchaudios_function():
    """The reference mel against a direct DFT of the same definition, float64."""
    import numpy as np

    from benchmark.reference import mel

    x = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    pad = torch.nn.functional.pad(x[:, None], (256, 256), mode="reflect")[:, 0]
    frames = pad.unfold(-1, 512, 160)
    n = np.arange(400)
    win = np.zeros(512)
    win[56:456] = 0.5 - 0.5 * np.cos(2 * np.pi * n / 400)
    spec = np.fft.rfft(frames.numpy() * win, axis=-1)
    want = np.einsum("btf,fm->bmt", np.abs(spec) ** 2, mel.filterbank())
    got = mel.mel_spectrogram(x.float()).double().numpy()
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
