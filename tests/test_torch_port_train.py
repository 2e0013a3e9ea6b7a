"""The port's SDT-BP train step against the JAX package's, on the CPU.

The JAX ``Voice2Pose`` pipeline is built on a synthetic speaker (8 clips,
batch 4, full width, full-length audio, fp32); the port gets its weights
(``utils.weights.state_from_jax``) and reads the same directory with its own
loader, so both see the same batches.
"""

import os

import jax
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (
    Voice2PoseTrainState, train_step)
from speechdrivestemplates_tpu_torch.utils.weights import state_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
STEPS = 3


def _jax_cfg(root=None, **overrides):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.DATASET.SPEAKER = "oliver"
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TRAIN.VALIDATE = False
    cfg.TRAIN.SAVE_VIDEO = False
    cfg.TRAIN.LR_SCHEDULER = False
    cfg.SYS.MESH.DATA = 1
    if root is not None:
        cfg.DATASET.ROOT_DIR = root
    for k, v in overrides.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    cfg.freeze()
    return cfg


def _port_cfg(root, precision="fp32"):
    return apply_overrides(sdt_bp(precision=precision), [
        "DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4",
        "TRAIN.LR_SCHEDULER", "False",
        "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"])


def _batches(loader, n, schedule):
    """The first ``n`` batches of a run whose epochs count from 1; ``schedule``
    holds the loader's ``set_epoch``."""
    out, epoch = [], 0
    while len(out) < n:
        epoch += 1
        schedule.set_epoch(epoch)
        out += list(loader)
    return out[:n]


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Three steps of the JAX pipeline and of the port from the same weights
    on the same batches: per step, each side's losses and the pose encoder's
    running statistics after it."""
    from speechdrivestemplates_tpu.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    root = str(tmp_path_factory.mktemp("slice") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=0)
    jcfg = _jax_cfg(root)
    pipe = get_pipeline(jcfg.PIPELINE_TYPE)(jcfg)
    pipe.setup_dataset(jcfg, "train")
    pipe.setup_model(jcfg)
    pipe.setup_optimizer()
    state0 = jax.device_get(pipe.state)

    cfg = _port_cfg(root)
    loader = train_loader(cfg)
    port = Voice2PoseTrainState(cfg, len(loader.dataset), "cpu")
    port.load(state_from_jax(state0))

    step_fn = pipe._get_train_step()
    jstate, key = pipe.state, jax.random.PRNGKey(0)
    run = {"jax": [], "port": [], "state0": state0, "cfg": cfg, "port_state": port}
    for jb, tb in zip(_batches(pipe.train_dataloader, STEPS, pipe.train_dataloader),
                      _batches(loader, STEPS, loader.batch_sampler)):
        np.testing.assert_array_equal(tb["clip_index"].numpy(), jb["clip_index"])
        key, sub = jax.random.split(key)
        jstate, jl, jr = step_fn(jstate, pipe._device_batch(jb), sub)
        stats = jax.device_get(jstate["batch_stats_pe"])
        run["jax"].append(({k: float(v) for k, v in jl.items()},
                           [(stats[f"ConvNormRelu_{i}"]["norm"]["mean"],
                             stats[f"ConvNormRelu_{i}"]["norm"]["var"]) for i in range(7)],
                           np.asarray(jr["poses_pred_batch"])))
        tl, tr = train_step(port, tb)
        if not run["jax"][1:]:  # the parameters after the first update, both sides
            first = state_from_jax(jax.device_get(jstate))
            run["first_update"] = {
                "jax": (first["generator"], first["clips_code"]),
                "port": ({k: v.detach().clone() for k, v in port.generator.state_dict().items()},
                         port.clips_code.detach().clone())}
        run["port"].append(({k: float(v) for k, v in tl.items()},
                            [(b.norm.running_mean.numpy().copy(),
                              b.norm.running_var.numpy().copy())
                             for b in port.pose_encoder.blocks],
                            tr["poses_pred_batch"].numpy()))
    return run


@pytest.mark.parametrize("key", ["G_reg_loss", "G_loss", "L2_dist", "lip_sync_error_n"])
def test_first_step_losses_match_jax(slice_run, key):
    """At the pre-step weights the two steps compute the same function."""
    jl, tl = slice_run["jax"][0][0], slice_run["port"][0][0]
    np.testing.assert_allclose(tl[key], jl[key], rtol=1e-4)


def test_first_step_kl_is_zero(slice_run):
    """The bank starts at zero, so every code variance is 0 and the KL is skipped."""
    assert slice_run["jax"][0][0]["G_clipcode_kl_loss"] == 0.0
    assert slice_run["port"][0][0]["G_clipcode_kl_loss"] == 0.0


def test_three_step_losses_track_jax(slice_run):
    """Adam's first steps are ~lr * sign(grad), so the parameters are not gated
    elementwise; the losses they produce are. The KL takes the fp32 scale of
    docs/PARITY.md section 4: its codes are a few Adam steps from zero."""
    kl_seen = 0
    for (jl, *_), (tl, *_) in zip(slice_run["jax"], slice_run["port"]):
        np.testing.assert_allclose(tl["G_reg_loss"], jl["G_reg_loss"], rtol=1e-3)
        np.testing.assert_allclose(tl["G_clipcode_kl_loss"], jl["G_clipcode_kl_loss"],
                                   rtol=5e-2)
        kl_seen += jl["G_clipcode_kl_loss"] != 0.0
    assert kl_seen, "the KL term never became active in the run"


@pytest.mark.parametrize("part", ["generator", "clips_code"])
def test_first_adam_step_matches_jax(slice_run, part):
    """The first Adam update of every coordinate, port against JAX, from the
    same weights: lr * g / (|g| + eps), which is +-lr wherever |g| >> eps.
    Coordinates whose update is below lr / 10 on both sides (|g| < eps / 9)
    are left out. The rest part only where the gradient is so near zero that
    fp32 round-off shows in the update: of opposite sign on the two sides, or
    below 0.999 lr on both (|g| < ~1e3 eps). Measured: 0.38% of the
    generator's coordinates, at most 0.54% of a tensor's. A skipped,
    mis-scaled or mis-signed step moves every coordinate that moves (99.6%)
    off."""
    cfg = slice_run["cfg"]
    lr = cfg.TRAIN.LR
    if part == "clips_code":
        lr *= cfg.VOICE2POSE.GENERATOR.CLIP_CODE.LR_SCALING
    p0 = state_from_jax(slice_run["state0"])
    which = ("generator", "clips_code").index(part)
    before, jax_p, port_p = (p0[part], slice_run["first_update"]["jax"][which],
                             slice_run["first_update"]["port"][which])
    if part == "clips_code":
        before, jax_p, port_p = {"bank": before}, {"bank": jax_p}, {"bank": port_p}
    n = off = moved = 0
    for k, w0 in before.items():
        w0 = w0.double()
        dj, dt = jax_p[k].double() - w0, port_p[k].double() - w0
        # |g| < eps / 9 moves a coordinate by < lr / 10 on either side: left out
        differ = ((dt - dj).abs() > 1e-2 * lr) & (torch.maximum(dt.abs(), dj.abs()) > 0.1 * lr)
        # where they part, the gradient is small enough for round-off to show
        near_zero = (dt * dj <= 0) | (torch.maximum(dt.abs(), dj.abs()) < 0.999 * lr)
        assert near_zero[differ].all(), k
        assert differ.double().mean() <= 1e-2, (k, int(differ.sum()), w0.numel())
        n += w0.numel()
        off += int(differ.sum())
        moved += int((dj.abs() > 0.5 * lr).sum())
    print(f"{part}: {n} coordinates, {moved} moved by > lr/2 in JAX; {off} updates "
          f"differ by > lr/100 ({off / n:.3e})")
    assert moved >= n // 2 and off <= 5e-3 * n


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_adam_matches_jax_on_identical_gradients(slice_run, wd):
    """The port's two optimizers, as ``Voice2PoseTrainState`` builds them,
    against the JAX package's ``_adam`` as its ``setup_optimizer`` builds them
    (the generator at TRAIN.LR with TRAIN.WD, the bank at LR x LR_SCALING with
    no decay), over three steps of the same gradients from the same weights.
    Gradient magnitudes are log-uniform over 1e-10..1e-1 with random signs, so
    eps (|g| ~ 1e-8), the betas (from step 2), the L2 decay (|g| ~ wd |w|) and
    the bank's LR_SCALING (10 here) each move the result."""
    import optax

    from speechdrivestemplates_tpu.pipelines.voice2pose import _adam
    from speechdrivestemplates_tpu_torch.utils.weights import params_from_jax

    cfg = apply_overrides(sdt_bp(precision="fp32"), [
        "TRAIN.WD", str(wd), "VOICE2POSE.GENERATOR.CLIP_CODE.LR_SCALING", "10"])
    lr, lr_code = cfg.TRAIN.LR, cfg.TRAIN.LR * 10
    state0 = slice_run["state0"]
    port = Voice2PoseTrainState(cfg, state0["clips_code"].shape[0], "cpu")
    port.load(state_from_jax(state0))
    jax_p = {"g": state0["params_g"], "code": state0["clips_code"]}
    tx = {"g": _adam(lr, wd), "code": _adam(lr_code, 0.0)}
    opt = {k: tx[k].init(jax_p[k]) for k in tx}
    rng = np.random.RandomState(0)

    def grad_like(a):
        mag = 10.0 ** rng.uniform(-10, -1, np.shape(a))
        return (mag * rng.choice([-1.0, 1.0], np.shape(a))).astype(np.float32)

    for _ in range(3):
        grads = {"g": jax.tree.map(grad_like, jax_p["g"]), "code": grad_like(jax_p["code"])}
        for k in tx:
            upd, opt[k] = tx[k].update(grads[k], opt[k], jax_p[k])
            jax_p[k] = optax.apply_updates(jax_p[k], upd)
        g_port = params_from_jax(grads["g"])
        for name, p in port.generator.named_parameters():
            p.grad = g_port[name].clone()
        port.clips_code.grad = torch.from_numpy(grads["code"])
        port.opt_g.step()
        port.opt_code.step()

    p0 = state_from_jax(state0)
    want = dict(params_from_jax(jax.device_get(jax_p["g"])),
                bank=torch.from_numpy(np.asarray(jax_p["code"])))
    got = dict(port.generator.state_dict(), bank=port.clips_code.detach())
    worst = 0.0
    for k, w0 in dict(p0["generator"], bank=p0["clips_code"]).items():
        step_lr = lr_code if k == "bank" else lr
        dj, dt = want[k].double() - w0.double(), got[k].double() - w0.double()
        # the two sides round each step's weights to fp32: 3 ulps of the weight
        ulp = torch.from_numpy(np.spacing(np.abs(got[k].numpy()))).double()
        err = float(((dt - dj).abs() - 3 * ulp).max()) / step_lr
        worst = max(worst, err)
        assert err <= 1e-3, (k, err)
    print(f"wd {wd}: largest difference of the 3-step change beyond 3 ulps {worst:.3e} lr")


@pytest.mark.parametrize("step,bound", [(0, 1e-5), (1, 2e-3), (2, 1e-2)])
def test_predictions_part_only_through_adam(slice_run, step, bound):
    """Pixel-space predictions, relative L2: at step 1 (pre-step weights) the
    two forwards agree to fp32 round-off; each later step's weights come from
    Adam updates of fp32 gradients whose near-zero coordinates flip sign
    between the two implementations, so the predictions part a little more
    each step (measured ~4e-4 at step 2, ~2e-3 at step 3)."""
    got, want = slice_run["port"][step][2], slice_run["jax"][step][2]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"step {step + 1}: predictions rel L2 {rel:.3e}")
    assert rel <= bound, rel


@pytest.mark.parametrize("step", range(STEPS))
def test_pose_encoder_statistics_track_jax(slice_run, step):
    """Two train-mode BN updates a step (prediction, then ground truth), per
    tensor by relative L2. At step 1 both sides feed the encoder the same
    prediction (pre-step weights): 1e-3. From step 2 on, each side's
    prediction comes from its own Adam update, whose first steps are ~lr *
    sign(grad): fp32 round-off in the gradient flips near-zero coordinates
    (test_first_adam_step_matches_jax), the predictions part by ~4e-4 (step 2)
    and ~2e-3 (step 3) relative, and the small-batch BN statistics deep in the
    encoder carry that (measured 9.9e-4 at step 2, 4.0e-3 at step 3, block
    6): 2e-3 at step 2, 1e-2 at step 3. One generator update left out moves
    them by 1.7e-2 or more at step 2. The encoder's own update is held on
    identical inputs in tests/test_torch_port_pose_encoder.py."""
    bound = (1e-3, 2e-3, 1e-2)[step]
    worst = 0.0
    for i, ((jm, jv), (tm, tv)) in enumerate(zip(slice_run["jax"][step][1],
                                                 slice_run["port"][step][1])):
        for name, got, want in (("running_mean", tm, jm), ("running_var", tv, jv)):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= bound, (f"blocks.{i}.norm.{name}", rel)
            worst = max(worst, rel)
    print(f"step {step + 1}: pose-encoder statistics, largest rel L2 {worst:.3e}")


def test_checkpoint_has_the_reference_keys(slice_run, tmp_path):
    """The trainer's checkpoint holds the keys and buffers of the JAX
    package's reference export, under ``module.``."""
    from speechdrivestemplates_tpu.utils.torch_export import export_voice2pose

    ref = export_voice2pose(slice_run["state0"])
    path = str(tmp_path / "ckpt.pth")
    slice_run["port_state"].save_checkpoint(path, epoch=2, step=3)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (2, 3)
    msd = ckpt["model_state_dict"]
    assert set(msd) == {f"module.{k}" for k in ref}
    for k, v in ref.items():
        assert tuple(msd[f"module.{k}"].shape) == np.shape(v), k
    for k in ("mel_transfm.spectrogram.window", "mel_transfm.mel_scale.fb"):
        np.testing.assert_array_equal(msd[f"module.{k}"].numpy(), ref[k])
