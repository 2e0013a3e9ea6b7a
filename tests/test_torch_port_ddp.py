"""Data parallelism over ranks: the port's global-batch steps and evaluations.

JAX's data parallelism is one global batch split over a mesh: every loss,
batch statistic and metric is the global batch's. The port's ranks compute
the same (``parallel/dist.py``). Here two gloo ranks on the CPU
(``parallel.dist.spawn``) are held:
  * the SDT-BP step, to the JAX package's step on a 2-device mesh of
    ``tests/conftest.py``'s CPU devices from the same weights on the same
    global batch, at ``tests/test_torch_port_train.py``'s first-step gates:
    losses rtol 1e-4, the pose encoder's BN statistics rel L2 1e-3; the
    rank-local KL (each rank's own rows) is shown to miss the 1e-4 gate;
  * the SDT-BP, s2g (BN generator, LSGAN discriminator) and Pose2Pose steps,
    to the port's one-process step on the same global batch (the ranks'
    rows in rank order): every gradient after the mean over ranks (the code
    bank's and BN's included) against its tensor's largest, the BN running
    statistics, the losses, the parameters after Adam's first update
    wherever the gradient is not round-off (|g| > 1e-3 max|g| and > 1e3 x
    Adam's eps: the first update is lr * g / (|g| + eps), ~lr * sign(g), so
    round-off in a gradient near zero may flip its sign or move it), the
    second step's losses (SDT-BP, Pose2Pose); the two ranks bit for bit equal.
    SDT-BP runs in fp32 (gates 1e-5, 1e-5, 1e-5, 1e-6 and 1e-3, the last
    test_torch_port_train's once Adam has moved the weights). s2g and
    Pose2Pose run in float64 (1e-10, 1e-10, 1e-10, 1e-9, 1e-8): a train-mode
    BN's fp32 weight gradient is a small remainder of cancelling terms, so the
    order of its sums alone moves it by up to ~1e-2 relative in the encoder's
    first layers, in one process as much as across ranks;
  * ragged and padded evaluations (SDT-BP with FGD, Pose2Pose with its
    noise draws), equal on both ranks and to the one-process evaluation of
    the same global batches (rtol 1e-5 in fp32, 1e-8 in float64);
  * a checkpoint written by rank 0 alone and a resume on two ranks, bit for
    bit against the straight run;
  * ``main`` with SYS.WORLD_SIZE 2 on the CPU: training, ``--test_only`` and
    the sequence-parallel ``--demo_input``.
"""

import glob
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.parallel import dist as pdist

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 600
NUM_TRAIN, NUM_DEV = 8, 7
BANK_SEED = 5
LR = 1e-3
ADAM_EPS = 1e-8


@pytest.fixture(scope="module", autouse=True)
def rank_threads():
    """Two intra-op threads a spawned rank (they inherit the variable) and in
    this process while the module runs: the test session runs several
    workers on the host's cores already."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setenv("OMP_NUM_THREADS", "2")
            yield
    finally:
        torch.set_num_threads(threads)


def _cfg(preset: str, root: str, *extra):
    from speechdrivestemplates_tpu_torch import config as C

    return C.apply_overrides(getattr(C, preset)(precision="fp32"), [
        "DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4",
        "TEST.BATCH_SIZE", "6", "TRAIN.LR_SCHEDULER", "False", "TRAIN.LR", str(LR),
        "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False", *extra])


def _bank():
    return torch.from_numpy(np.random.RandomState(BANK_SEED).randn(NUM_TRAIN, 32)
                            .astype(np.float32))


def _named_params(state):
    named = {}
    for prefix, attr in (("netG.", "generator"), ("netD_pose.", "discriminator"), ("ae.", "ae")):
        module = getattr(state, attr, None)
        if module is not None:
            named.update({prefix + n: p for n, p in module.named_parameters()})
    if isinstance(getattr(state, "clips_code", None), torch.nn.Parameter):
        named["clips_code"] = state.clips_code
    return named


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for k, v in sorted(tensors.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _local_kl(code: torch.Tensor, cfg) -> float:
    """The clip-code KL of one rank's own rows: what a per-rank statistic
    (plain DDP) would compute."""
    mu, var = code.mean(0), code.var(0, correction=1)
    return float(0.5 * (-torch.log(var) + mu ** 2 + var - 1.0).mean()
                 * cfg.VOICE2POSE.GENERATOR.LAMBDA_CLIP_KL)


def _to_double(state) -> None:
    """The state's modules, their compute dtype and the code bank in float64
    (the parameters stay the objects the optimizers hold)."""
    for attr in ("generator", "discriminator", "pose_encoder", "ae"):
        module = getattr(state, attr, None)
        if module is not None:
            module.double()
            for sub in module.modules():
                if isinstance(getattr(sub, "dtype", None), torch.dtype):
                    sub.dtype = torch.float64
    if isinstance(getattr(state, "clips_code", None), torch.nn.Parameter):
        state.clips_code.data = state.clips_code.data.double()


def _run(spec, global_batches=None):
    """One preset's evaluation, then its train steps, from the spec's
    weights: this rank's shards under a process group, or, with
    ``global_batches`` (the ranks' index lists), the one-process steps and
    evaluation of the same global batches."""
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    cfg = _cfg(spec["preset"], spec["root"])
    p = trainer.pipeline(cfg)
    state = p.state(cfg, NUM_TRAIN, "cpu")
    if spec.get("weights"):
        state.load(torch.load(spec["weights"], weights_only=False))
    if isinstance(getattr(state, "clips_code", None), torch.nn.Parameter):
        with torch.no_grad():
            state.clips_code.copy_(_bank())
    if spec.get("double"):
        _to_double(state)
    if global_batches is None:
        val = trainer.eval_loader(cfg)
        loader = trainer.train_loader(cfg)
        loader.batch_sampler.set_epoch(1)
        batches = list(loader)[:spec["steps"]]
    else:
        val_ds = GestureDataset(spec["root"], "oliver", cfg, split="val")
        val = torch.utils.data.DataLoader(val_ds, batch_sampler=global_batches["eval"],
                                          collate_fn=collate)
        train_ds = GestureDataset(spec["root"], "oliver", cfg)
        batches = [collate([train_ds[i] for i in idx]) for idx in global_batches["train"]]
    out = {"eval_index": [b["clip_index"].tolist() for b in val],
           "train_index": [b["clip_index"].tolist() for b in batches],
           "metrics": trainer.evaluate(state, val) if spec.get("eval", True) else None,
           "losses": []}
    for t, b in enumerate(batches):
        if t == 0 and spec["preset"] == "sdt_bp":
            out["local_kl"] = _local_kl(state.clips_code.detach()[b["clip_index"]], cfg)
        losses, _ = p.train_step(state, b)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if t == 0:
            out["grads"] = {k: v.grad.clone() for k, v in _named_params(state).items()
                            if v.grad is not None}
            out["state"] = {k: v.clone() for k, v in state.state_dict().items()}
    return out


def _steps_worker(rank, device, specs):
    outs = []
    for spec in specs:
        o = _run(spec)
        o["digest"] = _digest({**o["state"], **{"grad." + k: v for k, v in o["grads"].items()}})
        if rank:  # rank 1's weights and gradients are held by their digest
            o = {k: v for k, v in o.items() if k not in ("state", "grads")}
        outs.append(o)
    return outs


@pytest.fixture(scope="module")
def speaker(tmp_path_factory):
    from speechdrivestemplates_tpu.datasets.synthetic import make_synthetic_speaker

    root = str(tmp_path_factory.mktemp("ddp") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=NUM_TRAIN, num_dev=NUM_DEV)
    return root


@pytest.fixture(scope="module")
def jax_step(speaker, tmp_path_factory):
    """The JAX SDT-BP step on a 2-device mesh (fp32, global batch 4, a random
    bank so that the KL is active from the first step): its losses, the pose
    encoder's statistics after it, and its initial weights for the port."""
    import jax

    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu_torch.utils.weights import state_from_jax

    cfg = get_cfg_defaults()
    cfg.merge_from_file(str(ROOT / "configs" / "voice2pose_sdt_bp.yaml"))
    cfg.DATASET.SPEAKER, cfg.DATASET.ROOT_DIR = "oliver", speaker
    cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.PRECISION = 4, "fp32"
    cfg.TRAIN.VALIDATE, cfg.TRAIN.SAVE_VIDEO, cfg.TRAIN.LR_SCHEDULER = False, False, False
    cfg.SYS.MESH.DATA = 2
    cfg.freeze()
    pipe = get_pipeline(cfg.PIPELINE_TYPE)(cfg)
    pipe.setup_dataset(cfg, "train")
    pipe.setup_model(cfg)
    pipe.setup_optimizer()
    assert pipe.mesh.size == 2
    pipe.state["clips_code"] = jax.numpy.asarray(_bank().numpy())
    weights = str(tmp_path_factory.mktemp("ddp_w") / "jax_init.pt")
    torch.save(state_from_jax(jax.device_get(pipe.state)), weights)
    pipe.train_dataloader.set_epoch(1)
    batch = next(iter(pipe.train_dataloader))
    state, losses, _ = pipe._get_train_step()(pipe.state, pipe._device_batch(batch),
                                               jax.random.PRNGKey(0))
    stats = jax.device_get(state["batch_stats_pe"])
    return {"weights": weights, "index": sorted(np.asarray(batch["clip_index"]).tolist()),
            "losses": {k: float(v) for k, v in losses.items()},
            "stats": [(stats[f"ConvNormRelu_{i}"]["norm"]["mean"],
                       stats[f"ConvNormRelu_{i}"]["norm"]["var"]) for i in range(7)]}


@pytest.fixture(scope="module")
def runs(speaker, jax_step):
    """Two ranks, then one process on the same global batches, per preset."""
    specs = [{"preset": "sdt_bp", "root": speaker, "weights": jax_step["weights"], "steps": 2},
             {"preset": "s2g", "root": speaker, "steps": 1, "double": True, "eval": False},
             {"preset": "pose2pose", "root": speaker, "steps": 2, "double": True}]
    ranks = pdist.spawn(_steps_worker, 2, (specs,), device="cpu", timeout_s=RANK_TIMEOUT_S)
    out = {}
    for i, spec in enumerate(specs):
        r0, r1 = ranks[0][i], ranks[1][i]
        glob_batches = {k: [a + b for a, b in zip(r0[k], r1[k])]
                        for k in ("eval_index", "train_index")}
        one = _run(spec, {"eval": glob_batches["eval_index"],
                          "train": glob_batches["train_index"]})
        out[spec["preset"]] = {"ranks": (r0, r1), "one": one}
    return out


PRESETS = ["sdt_bp", "s2g", "pose2pose"]
# preset -> gates: gradient (of its tensor's largest), first-step losses, BN
# statistics, moved parameters, second-step losses, evaluation metrics
GATES = {"sdt_bp": (1e-5, 1e-5, 1e-5, 1e-6, 1e-3, 1e-5),
         "s2g": (1e-10, 1e-10, 1e-10, 1e-9, 1e-8, 1e-8),
         "pose2pose": (1e-10, 1e-10, 1e-10, 1e-9, 1e-8, 1e-8)}


def test_sdt_bp_two_ranks_match_jaxs_two_device_step(runs, jax_step):
    """The ranks' global batch is JAX's (the same clips); the first step's
    losses and the FGD encoder's statistics are JAX's at the one-process
    port's gates; and a rank-local KL misses the gate."""
    r0, r1 = runs["sdt_bp"]["ranks"]
    assert sorted(r0["train_index"][0] + r1["train_index"][0]) == jax_step["index"]
    jl = jax_step["losses"]
    assert jl["G_clipcode_kl_loss"] > 0
    for r in (r0, r1):
        for k, v in jl.items():
            np.testing.assert_allclose(r["losses"][0][k], v, rtol=1e-4, err_msg=k)
    for i, (jm, jv) in enumerate(jax_step["stats"]):
        for name, want in (("running_mean", jm), ("running_var", jv)):
            got = r0["state"][f"pose_encoder.blocks.{i}.norm.{name}"].numpy()
            assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3, (i, name)
    for r in (r0, r1):
        rel = abs(r["local_kl"] - jl["G_clipcode_kl_loss"]) / jl["G_clipcode_kl_loss"]
        assert rel > 1e-4, (r["local_kl"], jl["G_clipcode_kl_loss"])
        print(f"rank-local KL {r['local_kl']:.6f} against JAX's {jl['G_clipcode_kl_loss']:.6f}"
              f" (rel {rel:.3e}, gate 1e-4)")


@pytest.mark.parametrize("preset", PRESETS)
def test_ranks_are_equal_bit_for_bit(runs, preset):
    r0, r1 = runs[preset]["ranks"]
    assert r0["digest"] == r1["digest"]
    assert r0["losses"] == r1["losses"] and r0["metrics"] == r1["metrics"]


@pytest.mark.parametrize("preset", PRESETS)
def test_two_rank_gradients_are_the_global_batchs(runs, preset):
    """After the mean over ranks every gradient is the one-process
    gradient of the global batch: a factor of the world size off in the
    terms through a global statistic (the KL's, BN's) would show in the
    code bank's and BN's weight and bias gradients, checked here with the
    rest."""
    r0, one = runs[preset]["ranks"][0], runs[preset]["one"]
    assert r0["grads"].keys() == one["grads"].keys()
    names = list(one["grads"])
    assert any(".norm." in n for n in names) or preset == "sdt_bp"
    if preset == "sdt_bp":
        assert "clips_code" in names
    gate = GATES[preset][0]
    for k in names:
        g, ref = r0["grads"][k], one["grads"][k]
        scale = ref.abs().max().item()
        assert scale > 0, k
        assert (g - ref).abs().max().item() <= gate * scale, (k, (g - ref).abs().max().item(),
                                                              scale)


@pytest.mark.parametrize("preset", PRESETS)
def test_two_rank_statistics_parameters_and_losses_are_the_global_batchs(runs, preset):
    r0, one = runs[preset]["ranks"][0], runs[preset]["one"]
    _, loss1, stat, param, loss2, _ = GATES[preset]
    for k, v in one["losses"][0].items():
        np.testing.assert_allclose(r0["losses"][0][k], v, rtol=loss1, err_msg=k)
    for t in range(1, len(one["losses"])):  # s2g takes one step
        for k, v in one["losses"][t].items():
            np.testing.assert_allclose(r0["losses"][t][k], v, rtol=loss2, err_msg=k)
    stats = [k for k in one["state"] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(r0["state"][k], one["state"][k], rtol=stat,
                                   atol=stat * one["state"][k].abs().max().item(), err_msg=k)
    for k, g in one["grads"].items():
        # Adam's first update is lr * g / (|g| + eps): where |g| nears eps (1e-8), round-off
        # in g moves it too
        moved = (g.abs() > 1e-3 * g.abs().max()) & (g.abs() > 1e3 * ADAM_EPS)
        np.testing.assert_allclose(r0["state"][k][moved], one["state"][k][moved],
                                   rtol=param, atol=param * LR, err_msg=k)


@pytest.mark.parametrize("preset", ["sdt_bp", "pose2pose"])
def test_ragged_padded_eval_is_the_global_batchs(runs, preset):
    """7 val clips, TEST.BATCH_SIZE 6 over 2 ranks: 3 a rank, shards of 4
    (one of them JAX's pad row), so a batch of 3 and a ragged one of 1 a
    rank. Each rank's metrics, FGD included, are the one-process evaluation
    of the same global batches, weighted as JAX weighs them."""
    r0, r1 = runs[preset]["ranks"]
    assert [len(b) for b in r0["eval_index"]] == [3, 1]
    assert sorted(sum(r0["eval_index"] + r1["eval_index"], [])) == [0, 0, 1, 2, 3, 4, 5, 6]
    one = runs[preset]["one"]["metrics"]
    assert r0["metrics"].keys() == one.keys()
    if preset == "sdt_bp":
        assert {"FGD_mu", "FGD_mu_logvar"} <= set(one)
    for k, v in one.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=GATES[preset][5], err_msg=k)


# ---- a checkpoint by rank 0, a resume on two ranks -----------------------------------------

def _resume_worker(rank, device, root, out):
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    def cfg(epochs, where):
        return _cfg("pose2pose", root, "TRAIN.NUM_EPOCHS", str(epochs), "SYS.OUTPUT_DIR",
                    os.path.join(out, where), "TRAIN.VALIDATE", "False")

    straight = trainer.train(cfg(2, "straight"), "p2p", "cpu")
    first = trainer.train(cfg(1, "resumed"), "p2p", "cpu")
    resumed = trainer.train(cfg(2, "resumed"), "p2p", "cpu", resume_from=first["checkpoint"])
    return {"straight": straight, "first": first, "resumed": resumed}


def test_checkpoint_by_rank_0_and_a_resume_on_two_ranks(speaker, tmp_path):
    """Pose2Pose on two ranks, 2 epochs straight and 1 + a resume for 1 more
    from the checkpoint rank 0 wrote: the last checkpoints are equal bit for
    bit; each run made one directory, which the resume continued; every rank
    reports the same run."""
    from speechdrivestemplates_tpu_torch.utils.weights import read_pth

    r0, r1 = pdist.spawn(_resume_worker, 2, (speaker, str(tmp_path)), device="cpu",
                         timeout_s=RANK_TIMEOUT_S)
    assert r0 == r1
    for where in ("straight", "resumed"):
        assert len(os.listdir(tmp_path / where)) == 1
    assert os.path.dirname(r0["resumed"]["checkpoint"]) == \
        os.path.dirname(r0["first"]["checkpoint"])
    assert r0["resumed"]["resumed_from"] == r0["first"]["checkpoint"]
    a, b = read_pth(r0["straight"]["checkpoint"]), read_pth(r0["resumed"]["checkpoint"])
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert r0["straight"]["losses"] == r0["resumed"]["losses"]


# ---- main with SYS.WORLD_SIZE 2 ---------------------------------------------------------------

def test_main_trains_tests_and_runs_the_sequence_parallel_demo_on_two_ranks(speaker, tmp_path):
    """``main --device cpu SYS.WORLD_SIZE 2``: a training run,
    ``--test_only`` of its checkpoint (FGD included), and ``--demo_input`` with
    DEMO.SEQUENCE_PARALLEL True, whose poses are the dense forward of the
    clip padded for two ranks (rel < 1e-4, JAX's gate)."""
    from scipy.io import wavfile

    from speechdrivestemplates_tpu_torch import main
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState

    opts = ["DATASET.ROOT_DIR", speaker, "SYS.OUTPUT_DIR", str(tmp_path), "SYS.WORLD_SIZE", "2",
            "SYS.MASTER_PORT", str(pdist.free_port()), "TRAIN.PRECISION", "fp32",
            "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "6",
            "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False"]
    flags = ["--device", "cpu", "--tag", "ddp"]
    trained = main.main(flags + opts + ["TRAIN.NUM_EPOCHS", "1", "TRAIN.VALIDATE", "False"])
    assert trained["steps"] == 2 and os.path.exists(trained["checkpoint"])
    ckpt = trained["checkpoint"]
    tested = main.main(flags + ["--test_only", "--checkpoint", ckpt] + opts)
    assert tested["num_samples"] == NUM_DEV and np.isfinite(tested["metrics"]["FGD_mu"])
    assert os.path.basename(tested["output_dir"]).endswith("voice2pose_sdt_bp-TEST-ddp")

    t = np.arange(int(5.0 * 16000)) / 16000
    wav = str(tmp_path / "demo.wav")
    wavfile.write(wav, 16000, (0.1 * np.sin(2 * np.pi * 180 * t)).astype(np.float32))
    demoed = main.main(flags + ["--demo_input", wav, "--checkpoint", ckpt] + opts
                       + ["DEMO.SEQUENCE_PARALLEL", "True", "DEMO.CODE_INDEX", "1"])
    frames = demoed["num_frames"][0]
    with np.load(demoed["npz"][0]) as z:
        got = z["poses_pred_batch"]
    assert got.shape == (1, frames, 2, 121)
    assert len(glob.glob(os.path.join(demoed["output_dir"], "results", "*.npz"))) == 1

    cfg = _cfg("sdt_bp", speaker, "DEMO.CODE_INDEX", "1")
    state = Voice2PoseTrainState(cfg, None, "cpu")
    state.load_pth(ckpt)
    batch = collate([GestureDataset("unused", "oliver", cfg, split="demo", demo_input=wav)[0]])
    audio = batch["audio"][0].numpy()
    t_mel = -(-(len(audio) // 160 + 2) // 16) * 16
    pad = np.zeros(((t_mel - 1) * 160,), np.float32)
    pad[:len(audio)] = audio
    with torch.no_grad():
        state.generator.eval()
        pred = state.generator(mel_spectrogram(torch.from_numpy(pad[None])),
                               -(-frames // 64) * 64, state.clips_code[1][None])[:, :frames]
    stat = batch["speaker_stat"]
    ref = get_final_results(pred, stat["mean"], stat["std"], stat["scale_factor"], True,
                            121).numpy()
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-4, rel
    assert json.dumps(demoed)


def test_main_under_torchrun_is_one_rank_of_its_environment(speaker, tmp_path):
    """``torchrun`` starts the processes and sets RANK / WORLD_SIZE /
    LOCAL_RANK: each ``main`` joins that group (env://) as its rank, and rank
    0 alone prints the run's line. Pose2Pose, one epoch, on the CPU."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(pdist.free_port()), "-m", "speechdrivestemplates_tpu_torch.main",
           "--device", "cpu", "--config_file", str(ROOT / "configs" / "pose2pose.yaml"),
           "--tag", "torchrun", "DATASET.ROOT_DIR", speaker, "SYS.OUTPUT_DIR", str(tmp_path),
           "TRAIN.NUM_EPOCHS", "1", "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False",
           "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0"]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=RANK_TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and lines[0]["steps"] == 2, r.stdout[-3000:]
    assert len(os.listdir(tmp_path)) == 1 and os.path.exists(lines[0]["checkpoint"])
    assert "rank 0 of 2" in r.stderr


def test_sigterm_preempts_every_rank_at_the_same_step(speaker, tmp_path):
    """SIGTERM to ``main SYS.WORLD_SIZE 2`` (the launcher) reaches both ranks;
    they agree on the flag at the same step (``parallel.dist.agree``), rank 0
    writes one preemption checkpoint stamped epoch E-1 with its resume file,
    and the launcher exits 143. A kill timer fails a wedged run rather than
    hang."""
    import signal
    import subprocess
    import sys
    import threading

    from speechdrivestemplates_tpu_torch.pipelines import checkpoint as C

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "speechdrivestemplates_tpu_torch.main", "--device", "cpu",
           "--config_file", str(ROOT / "configs" / "pose2pose.yaml"), "--tag", "pre",
           "DATASET.ROOT_DIR", speaker, "SYS.OUTPUT_DIR", str(tmp_path), "SYS.WORLD_SIZE", "2",
           "SYS.MASTER_PORT", str(pdist.free_port()), "TRAIN.NUM_EPOCHS", "500",
           "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False", "TRAIN.CHECKPOINT_INTERVAL",
           "1000", "SYS.LOG_INTERVAL", "1", "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(RANK_TIMEOUT_S, proc.kill)
    killer.daemon = True
    killer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "global_step" in line:
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines) + rest
    assert proc.returncode == 143, (proc.returncode, text[-3000:])
    saved = [x for x in text.splitlines() if "Preemption checkpoint saved" in x]
    assert len(saved) == 2 and saved[0].split("saved")[1] == saved[1].split("saved")[1], saved
    ckpts = glob.glob(str(tmp_path / "*_pose2pose-TRAIN-pre" / "checkpoints" / "*.pth"))
    assert len(ckpts) == 1 and os.path.exists(C.resume_path(ckpts[0])), ckpts
