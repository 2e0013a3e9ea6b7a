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
             "probes", "pandas", "yaml", "yacs")


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
            "speechdrivestemplates_tpu_torch.ops.stem, "
            "speechdrivestemplates_tpu_torch.profile_kernels, "
            "speechdrivestemplates_tpu_torch.profile_train, "
            "speechdrivestemplates_tpu_torch.main, "
            "speechdrivestemplates_tpu_torch.datasets.synthetic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from speechdrivestemplates_tpu_torch import main, profile_kernels, profile_train, serving
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
    for probe in ([], ["--conv1-probe"], ["--shift-probe", "--probe-c", "64"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_kernels.main(probe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_train.main([])
    # training: the card unless --device cpu, before anything is read or written
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(["DATASET.ROOT_DIR", str(tmp_path / "none"),
                   "SYS.OUTPUT_DIR", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(["--device", "cuda", "TRAIN.VALIDATE", "False"])
    assert not (tmp_path / "out").exists()
    with pytest.raises(SystemExit):  # only the flags it implements
        main.main(["--device", "cpu", "--resume_from", "x"])


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


def test_kernel_wrappers_refuse_tensors_that_require_grad():
    """The kernels write through raw pointers: their outputs would carry no
    grad_fn. Each wrapper raises first, under grad mode, for any input that
    requires grad (the guard runs before the device check, so this holds on
    the CPU as on the card), and lets it through under no_grad."""
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops import conv1, mel, shift_probe, stem

    w1 = torch.zeros(64, 1, 3, 3, requires_grad=True)
    w2 = torch.zeros(64, 64, 4, 4, requires_grad=True)
    w3 = torch.zeros(128, 64, 3, 3)
    calls = {
        "mel": lambda: mel.mel_spectrogram_kernel(torch.zeros(1, 1000, requires_grad=True)),
        "conv1": lambda: conv1.conv1_in_kernel(torch.zeros(1, 80, 8), w1),
        "stem": lambda: stem.stem_tail_kernel(torch.zeros(1, 82, 8, 64), w2, w3),
        "whole stem": lambda: stem.stem_kernel(torch.zeros(1, 80, 8), w1, w2, w3),
        "shift": lambda: shift_probe.shift_taps_kernel(
            torch.zeros(1, 16, 64, dtype=torch.bfloat16, requires_grad=True),
            torch.zeros(9, 64, 64, dtype=torch.bfloat16), 8),
    }
    kernels.reset_launch_counts()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="has no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()  # past the guard: refused for lying on the CPU
    assert sum(kernels.LAUNCHES.values()) == 0
    kernels.refuse_grad("x", torch.zeros(2), torch.zeros(2, requires_grad=False))
    with torch.inference_mode():
        kernels.refuse_grad("x", torch.zeros(2, requires_grad=True))


def test_generator_route_follows_train_mode(monkeypatch, rng):
    """Train mode takes the plain stem under autograd (its convs get
    gradients); eval mode takes the kernel entry, as the JAX package runs its
    Pallas stem at inference only. A serving forward first, then training, in
    one process: what serving caches must serve autograd too."""
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import stem as stem_ops

    entered = []

    def kernel_entry(*args, **kw):
        entered.append(True)
        return stem_ops.stem_plain(*args, **kw)

    monkeypatch.setattr(stem_ops, "audio_encoder_stem", kernel_entry)
    model = build_model("SequenceGeneratorCNN", sdt_bp(precision="fp32"), device="cpu")
    mel = torch.from_numpy(rng.randn(2, 80, 64).astype(np.float32))
    code = torch.from_numpy(rng.randn(2, 32).astype(np.float32))
    with torch.inference_mode():  # as serving runs it, caching its resize matrices
        model(mel, 32, code)
    assert entered == [True]
    model.train()
    model(mel, 32, code).square().mean().backward()
    assert entered == [True]
    for layer in model.audio_encoder.layers()[:3]:
        assert layer.conv.weight.grad is not None and layer.conv.weight.grad.abs().sum() > 0

