"""What the PyTorch port may not do: import JAX or the JAX package, run its
entry points on the CPU unasked, or count kernel launches it did not make."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speechdrivestemplates_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "speechdrivestemplates_tpu",
             "probes")


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax_nor_jax_package():
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in _port_sources()}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import speechdrivestemplates_tpu_torch.serving, "
            "speechdrivestemplates_tpu_torch.ops.stem; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from speechdrivestemplates_tpu_torch import serving
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model

    cfg = sdt_bp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("SequenceGeneratorCNN", cfg)
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.build_serving_fn(cfg, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.main([str(tmp_path / "x.pth"), str(tmp_path / "x.wav"),
                      str(tmp_path / "x.npz")])


def test_cpu_serving_launches_no_kernel(rng):
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram_kernel
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    cfg = sdt_bp(precision="fp32")
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(1)).state_dict()
    fn, has_code = build_serving_fn(cfg, sd, device="cpu")
    kernels.reset_launch_counts()
    out = fn(rng.randn(2, 16000).astype(np.float32) * 0.1,
             rng.randn(2, 32).astype(np.float32))
    assert has_code and out.shape == (2, 64, 2, 121) and torch.isfinite(out).all()
    assert sum(kernels.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        mel_spectrogram_kernel(torch.zeros(1, 16000))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_seeded_init_is_reproducible():
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model

    def weights(seed):
        return build_model("SequenceGeneratorCNN", sdt_bp(), device="cpu",
                           generator=torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = weights(3), weights(3), weights(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unet.e0.conv.weight"], c["unet.e0.conv.weight"])
