"""What the PyTorch port may not do: import JAX or the JAX package, run its
entry points on the CPU unasked, or count kernel launches it did not make."""

import ast
import json
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


def test_port_neither_names_nor_loads_the_jax_native_core(tmp_path):
    """The port builds its own item loader (``csrc/sdt_dataio.cpp`` into
    ``build/``): no file of it or ``chip_smoke.py`` names the repository's
    ``native/`` directory, and its items load no ``native/libsdt_dataio.so``."""
    import re

    names = re.compile(r"(?<![\w.-])native/|(join|Path)\(.*[\"']native[\"']")
    files = [f for f in sorted(PORT.rglob("*")) if f.suffix in (".py", ".cpp", ".cu")]
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in files + [ROOT / "chip_smoke.py"]
           for i, line in enumerate(f.read_text().splitlines(), 1) if names.search(line)]
    assert not bad, bad
    code = ("import sys; from speechdrivestemplates_tpu_torch.datasets import native_loader as nl; "
            "from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat; "
            "from speechdrivestemplates_tpu_torch.datasets.synthetic import "
            "make_synthetic_speaker as m; m(sys.argv[1], 'oliver', num_train=1, num_dev=0); "
            "st = get_speaker_stat('oliver', 121, True); "
            "assert nl.load_clip_native(sys.argv[1] + '/oliver/clip_0000.npz', 64, True, "
            "st['mean'], st['std'], 68266) is not None; "
            "print('\\n'.join(l.split()[-1] for l in open('/proc/self/maps') "
            "if 'libsdt_dataio' in l))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert set(r.stdout.split()) == {str(ROOT / "build" / "libsdt_dataio.so")}, r.stdout


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import speechdrivestemplates_tpu_torch.serving, "
            "speechdrivestemplates_tpu_torch.ops.stem, "
            "speechdrivestemplates_tpu_torch.profile_kernels, "
            "speechdrivestemplates_tpu_torch.main, "
            "speechdrivestemplates_tpu_torch.chain_e2e, "
            "speechdrivestemplates_tpu_torch.datasets.synthetic, "
            "speechdrivestemplates_tpu_torch.utils.streaming, "
            "speechdrivestemplates_tpu_torch.parallel.seqparallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_one_module_constructs_and_captures_cuda_graphs():
    """The capture protocol lives in one module: no other file of the port
    builds a ``CUDAGraph`` or enters ``torch.cuda.graph``."""
    found = {str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*.py"))
             if any(pat in f.read_text() for pat in ("CUDAGraph(", "torch.cuda.graph("))}
    assert found == {"speechdrivestemplates_tpu_torch/pipelines/graphed.py"}, found


def test_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from speechdrivestemplates_tpu_torch import main, profile_kernels, serving
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model

    cfg = sdt_bp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("SequenceGeneratorCNN", cfg)
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.build_serving_fn(cfg, sd)
    for extra in ([], ["--config_file", "configs/voice2pose_s2g.yaml"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.main([str(tmp_path / "x.pth"), str(tmp_path / "x.wav"),
                          str(tmp_path / "x.npz"), *extra])
    for probe in ([], ["--conv1-probe"], ["--shift-probe", "--probe-c", "64"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_kernels.main(probe)
    # training: the card unless --device cpu, before anything is read or written
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(["DATASET.ROOT_DIR", str(tmp_path / "none"),
                   "SYS.OUTPUT_DIR", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(["--device", "cuda", "TRAIN.VALIDATE", "False"])
    # resume and pretrain: the card first too, before the missing path is looked for
    for flag in ("--resume_from", "--pretrain_from"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main([flag, str(tmp_path / "missing.pth"),
                       "SYS.OUTPUT_DIR", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_test_and_pose2pose_entry_points_need_cuda(tmp_path):
    """The test run, the Pose2Pose and SDT-VAE training runs and their train
    states: the card unless the CPU is asked for, before anything is read or
    written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from speechdrivestemplates_tpu_torch import main
    from speechdrivestemplates_tpu_torch.config import pose2pose, sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines import trainer
    from speechdrivestemplates_tpu_torch.pipelines.pose2pose import Pose2PoseTrainState
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState

    from speechdrivestemplates_tpu_torch import chain_e2e

    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chain_e2e.main(["pose2pose", "--out", out])
    for argv in (["--test_only", "--checkpoint", str(tmp_path / "x.pth")],
                 ["--config_file", "configs/pose2pose.yaml"],
                 ["--config_file", "configs/voice2pose_sdt_vae.yaml"],
                 ["--config_file", "configs/voice2pose_s2g.yaml"],
                 ["--config_file", "configs/voice2pose_s2g.yaml", "--test_only",
                  "--checkpoint", str(tmp_path / "x.pth")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main([*argv, "SYS.OUTPUT_DIR", out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pose2PoseTrainState(pose2pose(), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Voice2PoseTrainState(sdt_bp(), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.test(sdt_bp(), str(tmp_path / "x.pth"))
    assert not (tmp_path / "out").exists()


def test_demo_entry_point_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    """``main --demo_input`` and ``trainer.demo``: the card unless the CPU is
    asked for, before anything is read or written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    from speechdrivestemplates_tpu_torch import main
    from speechdrivestemplates_tpu_torch.config import pose2pose, sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    out = str(tmp_path / "out")
    for cfg_file in ([], ["--config_file", "configs/voice2pose_s2g.yaml"],
                     ["--config_file", "configs/pose2pose.yaml"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main([*cfg_file, "--demo_input", str(tmp_path / "none.wav"), "--checkpoint",
                       str(tmp_path / "x.pth"), "SYS.OUTPUT_DIR", out,
                       "TEST.SAVE_VIDEO", "False"])
    for cfg in (sdt_bp(), pose2pose()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.demo(cfg, str(tmp_path / "x.pth"), str(tmp_path / "none.wav"))
    assert not (tmp_path / "out").exists()


def test_every_refusal_names_its_roadmap_item():
    """Each ``raise NotImplementedError`` in the port either says which
    queue-A item of ROADMAP.md will port what it refuses, or is one of the
    JAX package's own refusals, listed here: the sequence-parallel demo of a
    FRAME_VARIANT bank (JAX ``Voice2Pose._seq_parallel_demo_forward``).
    Since item 14 is ported, none is left of the first kind: the five
    parallel keys and DEMO.SEQUENCE_PARALLEL are accepted, in training, in an
    evaluation and in the demo, and the video options no longer refuse."""
    import re

    from speechdrivestemplates_tpu_torch.config import apply_overrides, load_config, sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines.trainer import check_trainer_options

    jax_refusals = {"voice2pose.py": ["DEMO.SEQUENCE_PARALLEL does not support FRAME_VARIANT"]}
    items, found = set(), {}
    for f in sorted(PORT.rglob("*.py")):
        text = f.read_text()
        for node in ast.walk(ast.parse(text)):
            if (isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", None) == "NotImplementedError"):
                src = " ".join(ast.get_source_segment(text, node).split())
                src = re.sub(r'"\s*"', "", src)  # implicit string concatenation
                own = [m for m in jax_refusals.get(f.name, []) if m in src]
                if own:
                    found.setdefault(f.name, []).extend(own)
                    continue
                item = re.search(r"queue A, item (\d+)", src)
                assert "ROADMAP.md" in src and item, (f.name, src)
                items.add(item.group(1))
    assert found == jax_refusals and not items, (found, items)
    cfg = sdt_bp()
    assert cfg.TRAIN.SAVE_VIDEO and cfg.TEST.SAVE_VIDEO  # JAX's defaults
    cfg.DEMO.SEQUENCE_PARALLEL = True
    for evaluates, demo in ((True, False), (False, False), (False, True)):
        check_trainer_options(cfg, evaluates=evaluates, demo=demo)
    away = {"SYS.DISTRIBUTED": "True", "SYS.WORLD_SIZE": "2", "SYS.MASTER_ADDR": "10.0.0.2",
            "SYS.MASTER_PORT": "29500", "SYS.MESH.DATA": "2"}
    for key, value in away.items():
        opts = [key, value] + (["SYS.WORLD_SIZE", "2"] if key == "SYS.MESH.DATA" else [])
        load_config(None, opts)
        check_trainer_options(apply_overrides(sdt_bp(), opts), evaluates=True)


def test_one_rank_defaults_spawn_nothing(monkeypatch):
    """``main``'s run with the default keys stays in this process: no rank
    is spawned and no process group starts; SYS.WORLD_SIZE 2 spawns two."""
    import argparse

    import torch.distributed as tdist

    from speechdrivestemplates_tpu_torch import main
    from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
    from speechdrivestemplates_tpu_torch.parallel import dist as pdist

    spawned = []

    def refuse(*a, **k):
        raise AssertionError("the one-rank defaults started a process group")

    monkeypatch.setattr(tdist, "init_process_group", refuse)
    monkeypatch.setattr(pdist, "spawn", lambda fn, world, *a, **k: spawned.append(world)
                        or [{"rank": r} for r in range(world)])
    monkeypatch.setattr(main, "run", lambda cfg, args, name, device: {"in_process": True})
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    args = argparse.Namespace()
    assert main.run_ranks(sdt_bp(), args, "x", torch.device("cpu")) == {"in_process": True}
    assert spawned == []
    cfg = apply_overrides(sdt_bp(), ["SYS.WORLD_SIZE", "2"])
    assert main.run_ranks(cfg, args, "x", torch.device("cpu")) == {"rank": 0}
    assert spawned == [2]


@pytest.fixture(scope="module")
def cpu_serving():
    """SDT-BP fp32's serving function on the CPU, built once for the module."""
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    cfg = sdt_bp(precision="fp32")
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(1)).state_dict()
    return build_serving_fn(cfg, sd, device="cpu")


def test_cpu_serving_launches_no_kernel(rng, cpu_serving):
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram_kernel

    fn, has_code = cpu_serving
    kernels.reset_launch_counts()
    out = fn(rng.randn(2, 16000).astype(np.float32) * 0.1,
             rng.randn(2, 32).astype(np.float32))
    assert has_code and out.shape == (2, 64, 2, 121) and torch.isfinite(out).all()
    assert sum(kernels.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        mel_spectrogram_kernel(torch.zeros(1, 16000))
    assert sum(kernels.LAUNCHES.values()) == 0


def test_cpu_serving_makes_no_graph(rng, cpu_serving):
    """On the CPU a repeated signature stays eager: no graph, no capture
    stream, every call counted ``eager``, and the same inputs give the same
    poses."""
    from speechdrivestemplates_tpu_torch import kernels

    fn, _ = cpu_serving
    fn.routes.clear()
    kernels.reset_launch_counts()
    audio = rng.randn(1, 4000).astype(np.float32) * 0.1
    code = rng.randn(1, 32).astype(np.float32)
    outs = [fn(audio, code) for _ in range(3)]
    assert dict(fn.routes) == {"eager": 3}
    assert fn.stream is None and not fn.graphs
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert not (kernels.LAUNCHES or kernels.CAPTURED or kernels.REPLAYED)


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


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bn_audio_encoder_never_takes_the_in_stem(monkeypatch, rng, train):
    """A BN audio encoder (s2g) runs its eight layers itself in train and in
    eval mode: the stem functions, which compute InstanceNorm, would raise
    here. Its output is the eight layers' on ``mel[:, None]``."""
    from speechdrivestemplates_tpu_torch.config import s2g
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import stem as stem_ops
    from speechdrivestemplates_tpu_torch.ops.resize import interpolate_bilinear

    def refuse(*args, **kw):
        raise AssertionError("a BN encoder reached an InstanceNorm stem function")

    for name in ("stem_plain", "audio_encoder_stem", "stem_kernel"):
        monkeypatch.setattr(stem_ops, name, refuse)
    encoder = build_model("SequenceGeneratorCNN", s2g(precision="fp32"),
                          device="cpu").audio_encoder.train(train)
    mel = torch.from_numpy(rng.randn(2, 80, 64).astype(np.float32))
    out = encoder(mel, 32)
    x = mel[:, None]
    with torch.no_grad():
        for layer in encoder.layers():
            x = layer(x)
    assert out.shape == (2, 256, 32)
    torch.testing.assert_close(out, interpolate_bilinear(x, (1, 32))[:, :, 0, :])


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



# ---- the kernels as torch.library ops, and the serving export ----------------------

def build_model_state(cfg):
    from speechdrivestemplates_tpu_torch.models import build_model

    return build_model("SequenceGeneratorCNN", cfg, device="cpu").state_dict()


def _op_cases():
    """Per op, two shapes: (op name, the op's arguments as (shape, dtype) or
    plain values, the plain version on CPU tensors of those shapes)."""
    from speechdrivestemplates_tpu_torch.ops import conv1, in_act, ln_gelu, mel, shift_probe, stem

    bf, f32 = torch.bfloat16, torch.float32
    tables = [((400, 512), bf)] * 2 + [((256, 80), bf)] * 2
    w2t, w3t = ((4, 4, 64, 64), bf), ((3, 3, 128, 64), bf)
    return {
        "mel": [([((b, n), f32), *tables],
                 lambda t: mel.mel_spectrogram_plain(torch.zeros(*t[0].shape)))
                for b, n in ((1, 300), (3, 16000))],
        "conv1_in": [([((b, 80, w), f32), ((64, 1, 3, 3), f32), 0.2, dt],
                      lambda t, dt=dt: conv1.conv1_in_plain(torch.zeros(*t[0].shape),
                                                            torch.zeros(64, 1, 3, 3), 0.2, dt))
                     for b, w, dt in ((1, 2, f32), (2, 101, bf))],
        "stem": [([((b, 82, w, 64), dt), (w2t[0], dt), (w3t[0], dt), 0.2],
                  lambda t, dt=dt: stem.stem_tail_plain(
                      torch.zeros(*t[0].shape, dtype=dt), torch.zeros(64, 64, 4, 4),
                      torch.zeros(128, 64, 3, 3), 0.2, dt))
                 for b, w, dt in ((1, 2, f32), (2, 101, bf))],
        "shift_taps": [([((n, m, c), bf), ((9, c, c), bf), m_out, True],
                        lambda t, m_out=m_out: shift_probe.shift_taps_plain(
                            torch.zeros(*t[0].shape, dtype=bf), torch.zeros(*t[1].shape,
                                                                            dtype=bf), m_out))
                       for n, m, c, m_out in ((1, 16, 64, 8), (3, 300, 128, 200))],
        "in_act": [([(shape, dt), 0.2],
                    lambda t, dt=dt: in_act.in_act_plain(torch.zeros(*t[0].shape, dtype=dt), 0.2))
                   for shape, dt in (((2, 256, 5, 51), bf), ((3, 256, 2), f32))],
        "ln_gelu": [([(shape, dt), ((shape[-1],), dt), ((shape[-1],), dt), ((shape[-1],), dt),
                      1e-5],
                     lambda t, dt=dt: ln_gelu.ln_gelu_plain(
                         *(torch.zeros(*a.shape, dtype=dt) for a in t[:4]), 1e-5))
                    for shape, dt in (((2, 213, 512), bf), ((3, 19, 32), f32))],
    }


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name", ["mel", "conv1_in", "stem", "shift_taps", "in_act", "ln_gelu"])
def test_op_fakes_give_the_plain_versions_shapes_on_fake_cuda_tensors(name, case):
    """Each kernel is the op ``torch.ops.sdt.<name>``; on fake CUDA tensors,
    as ``torch.export`` traces them, its fake gives the shape and dtype of the
    plain version's output and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from speechdrivestemplates_tpu_torch import kernels

    args, plain = _op_cases()[name][case]
    op = getattr(torch.ops.sdt, name)
    kernels.reset_launch_counts()
    with FakeTensorMode():
        fakes = [torch.empty(*a[0], dtype=a[1], device="cuda") if isinstance(a, tuple) else a
                 for a in args]
        out = op(*fakes)
    want = plain(fakes)
    assert out.device.type == "cuda"
    assert (tuple(out.shape), out.dtype) == (tuple(want.shape), want.dtype)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("preset, want", [
    ("sdt_bp", {"sdt.conv1_in": 1, "sdt.in_act": 21, "sdt.mel": 1, "sdt.stem": 1}),
    ("s2g", {"sdt.bn_act": 24, "sdt.mel": 1})])
def test_the_card_route_exports_its_kernel_ops_once_each(preset, want):
    """The card's serving route traced by ``torch.export`` on the CPU calls
    each kernel of the model's route once (``utils/export.py::route_ops``):
    SDT-BP mel, conv1 and the stem, and in_act once for each of its 21 IN
    layers after the stem; s2g (a BN encoder) the mel kernel, and bn_act once
    for each of its 24 BN layers.
    The trace takes meta tensors, which the wrappers route as CUDA tensors to
    the same ops' fakes: a CPU-only torch build has no CUDA device guard, so
    a fake CUDA tensor cannot be indexed there (the card's build traces fake
    CUDA tensors; the card's own export is held in chip_smoke.py)."""
    from speechdrivestemplates_tpu_torch import config, kernels
    from speechdrivestemplates_tpu_torch.serving import ServingModule
    from speechdrivestemplates_tpu_torch.utils.export import graph_ops, route_ops

    cfg = getattr(config, preset)(precision="bf16")
    sd = build_model_state(cfg)
    module = ServingModule(cfg, sd, "cpu").to("meta")
    args = (torch.empty(2, 68267, device="meta"),)
    if module.has_code:
        args += (torch.empty(2, 32, device="meta"),)
    kernels.reset_launch_counts()
    with torch.no_grad():
        module(*args)  # the eager call export_serving_fn makes first, filling the caches
        program = torch.export.export(module, args)
    assert graph_ops(program) == route_ops(module.model) == want
    assert not kernels.LAUNCHES
    out = [n for n in program.graph.nodes if n.op == "output"][0].args[0][0].meta["val"]
    assert tuple(out.shape) == (2, 64, 2, 121) and out.dtype == torch.float32


def test_kernel_launches_live_in_the_op_implementations_alone():
    """A source scan: ``data_ptr()``, the kernels' C entry points and the
    launch counter's increment appear in ``kernels/ops.py`` alone, which
    holds one of each per kernel, seven (``in_act`` and ``in_act_stats``
    share theirs)."""
    import re

    pattern = re.compile(r"data_ptr\(|sdt_\w+_forward\(|LAUNCHES\[[^\]]*\]\s*\+=")
    found = {str(f.relative_to(ROOT)): len(pattern.findall(f.read_text()))
             for f in _port_sources()}
    ops_file = "speechdrivestemplates_tpu_torch/kernels/ops.py"
    assert {k: v for k, v in found.items() if v} == {ops_file: found[ops_file]}
    text = (PORT / "kernels" / "ops.py").read_text()
    assert len(re.findall(r"LAUNCHES\[[^\]]*\]\s*\+= 1", text)) == 7
    assert len(re.findall(r"library\(\"\w+\"\)\.sdt_\w+_forward\(", text)) == 7


def test_runner_loads_no_model_code(tmp_path):
    """``run_artifact.py`` on an artifact, in a process of its own, leaves no
    model, pipeline, dataset, config or serving module of the port (nor JAX)
    in ``sys.modules``."""
    from scipy.io import wavfile

    from speechdrivestemplates_tpu_torch.config import s2g
    from speechdrivestemplates_tpu_torch.utils.export import export_serving_fn

    cfg = s2g(precision="fp32")
    ckpt = str(tmp_path / "s2g.pth")
    torch.save({"model_state_dict": {"module.netG." + k: v
                                     for k, v in build_model_state(cfg).items()}}, ckpt)
    art = str(tmp_path / "s2g.pt2")
    export_serving_fn(cfg, ckpt, art, audio_length=16000, device="cpu")
    wav = str(tmp_path / "in.wav")
    wavfile.write(wav, 16000, (np.random.RandomState(0).randn(8000) * 3000).astype(np.int16))
    runner = str(PORT / "run_artifact.py")
    code = ("import json, runpy, sys; "
            f"sys.argv = [{runner!r}, {art!r}, {wav!r}, {str(tmp_path / 'o.npz')!r}, "
            "'--device', 'cpu']; runpy.run_path(sys.argv[0], run_name='__main__'); "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('speechdrivestemplates_tpu_torch',)!r})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    loaded = json.loads(r.stdout.strip().splitlines()[-1])
    port = "speechdrivestemplates_tpu_torch."
    assert "speechdrivestemplates_tpu_torch.kernels.ops" in loaded
    assert not [m for m in loaded if m.split(".")[0] != "speechdrivestemplates_tpu_torch"
                or m.startswith(tuple(port + p for p in ("models", "pipelines", "datasets",
                                                         "config", "serving")))], loaded
    assert (tmp_path / "o.npz").exists()


def test_export_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the export runs on it")
    from speechdrivestemplates_tpu_torch import main
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.utils.export import export_serving_fn

    art = tmp_path / "a.pt2"
    for extra in ([], ["--device", "cuda"], ["--config_file", "configs/voice2pose_s2g.yaml"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main.main([*extra, "--export", str(art), "--checkpoint", str(tmp_path / "x.pth")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving_fn(sdt_bp(), str(tmp_path / "x.pth"), str(art))
    assert not art.exists()

