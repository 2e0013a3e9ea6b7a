"""The port's s2g-GAN train step against the JAX package's, on the CPU.

The JAX ``Voice2Pose`` pipeline is built from ``configs/voice2pose_s2g.yaml``
on a synthetic speaker (8 clips, batch 4, full width, full-length audio,
fp32): a code-less BN generator, the LSGAN ``PoseSequenceDiscriminator`` and
global poses. The port gets its weights (``utils.weights.state_from_jax``,
the discriminator's included) and reads the same directory with its own
loader, so both see the same batches. Three steps each; the JAX state after
each step is kept for the per-step gates.

s2g's trajectory is far more sensitive to round-off than SDT-BP's: the port
against itself, with every generator weight scaled by 1 + 1e-7 N(0, 1), parts
by 2.3e-02 (relative L2 of the step-3 predictions) where SDT-BP parts by
7.1e-04 (measured on the CPU, this fixture's speaker and batches). The GAN's
two networks feed each other's next update, and the BN generator's batch
statistics over 4 clips carry any change of one clip to all. So beyond step 1
the free-running comparison gates the regression loss only (at
tests/test_torch_port_train.py's bound); steps 2 and 3 are also run by the
port from JAX's state after the step before (weights, BN statistics, both
Adams' moments and counts: ``_load_jax_state``), and those are held at step
1's tolerances.
"""

import os

import jax
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, s2g
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                 disc_input, train_step)
from speechdrivestemplates_tpu_torch.utils.weights import (discriminator_params_from_jax,
                                                           params_from_jax, read_pth,
                                                           state_from_jax)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
STEPS = 3
# the loss keys of tests/test_pipeline_modes.py::test_s2g_gan_train_step
KEYS = ("G_loss", "G_reg_loss", "G_pose_gan_loss", "D_pose_gan_loss", "pose_score_fake",
        "pose_score_real", "L2_dist", "lip_sync_error_n")


def _jax_cfg(root):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_s2g.yaml"))
    cfg.merge_from_list(["DATASET.ROOT_DIR", root, "DATASET.SPEAKER", "oliver",
                         "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False",
                         "TRAIN.SAVE_VIDEO", "False", "TRAIN.LR_SCHEDULER", "False",
                         "SYS.MESH.DATA", "1", "SYS.NUM_WORKERS", "0"])
    cfg.freeze()
    return cfg


def _port_cfg(root):
    return apply_overrides(s2g(precision="fp32"), [
        "DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4",
        "TRAIN.LR_SCHEDULER", "False", "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"])


def _batches(loader, n, schedule):
    out, epoch = [], 0
    while len(out) < n:
        epoch += 1
        schedule.set_epoch(epoch)
        out += list(loader)
    return out[:n]


def _d_stats_jax(state):
    bs = jax.device_get(state["batch_stats_d"])
    return [(np.asarray(bs[f"ConvNormRelu_{i}"]["norm"]["mean"]),
             np.asarray(bs[f"ConvNormRelu_{i}"]["norm"]["var"])) for i in range(3)]


def _d_stats_port(d):
    return [(d.seq[i].norm.running_mean.detach().numpy().copy(),
             d.seq[i].norm.running_var.detach().numpy().copy()) for i in range(3)]


def _load_jax_state(port, jstate):
    """The port's state set to a JAX ``Voice2Pose.state``: weights, BN
    statistics, and each Adam's moments and step count (optax's
    ``ScaleByAdamState``, mapped by parameter name)."""
    port.load(state_from_jax(jstate))
    for opt, module, key, bs, to_torch in (
            (port.opt_g, port.generator, "opt_g", "batch_stats_g", params_from_jax),
            (port.opt_d, port.discriminator, "opt_d", "batch_stats_d",
             discriminator_params_from_jax)):
        adam = jstate[key][0]
        mu, nu = to_torch(adam.mu, jstate[bs]), to_torch(adam.nu, jstate[bs])
        for name, p in module.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}


def _record(losses, results, d):
    return ({k: float(v) for k, v in losses.items()}, _d_stats_port(d),
            results["poses_pred_batch"].numpy())


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Three s2g steps of the JAX pipeline and of the port from the same
    weights on the same batches: per step, each side's losses, D's running
    statistics after it and the pixel-space predictions, and the port's step
    from JAX's state before it ("synced"); the states before and after the
    first step."""
    from speechdrivestemplates_tpu.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    root = str(tmp_path_factory.mktemp("s2g") / "speakers")
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
    synced = Voice2PoseTrainState(cfg, len(loader.dataset), "cpu")
    run = {"jax": [], "port": [], "synced": [], "state0": state0, "cfg": cfg,
           "port_state": port, "pipe": pipe}
    for jb, tb in zip(_batches(pipe.train_dataloader, STEPS, pipe.train_dataloader),
                      _batches(loader, STEPS, loader.batch_sampler)):
        np.testing.assert_array_equal(tb["clip_index"].numpy(), jb["clip_index"])
        _load_jax_state(synced, jax.device_get(jstate))
        key, sub = jax.random.split(key)
        jstate, jl, jr = step_fn(jstate, pipe._device_batch(jb), sub)
        run["jax"].append(({k: float(v) for k, v in jl.items()}, _d_stats_jax(jstate),
                           np.asarray(jr["poses_pred_batch"])))
        if len(run["jax"]) == 1:
            run["batch1"], run["state1"] = tb, jax.device_get(jstate)
        run["port"].append(_record(*train_step(port, tb), port.discriminator))
        if len(run["port"]) == 1:
            run["first_update"] = {k: v.detach().clone()
                                   for k, v in port.discriminator.state_dict().items()}
        run["synced"].append(_record(*train_step(synced, tb), synced.discriminator))
    return run


def test_loss_keys_are_the_jax_keys(slice_run):
    jl, tl = slice_run["jax"][0][0], slice_run["port"][0][0]
    assert set(KEYS) <= set(jl) and set(tl) == set(jl), (sorted(tl), sorted(jl))


@pytest.mark.parametrize("key", KEYS)
def test_first_step_losses_match_jax(slice_run, key):
    """At the pre-step weights the two steps compute the same function."""
    jl, tl = slice_run["jax"][0][0], slice_run["port"][0][0]
    np.testing.assert_allclose(tl[key], jl[key], rtol=1e-4)


def test_three_step_regression_loss_tracks_jax(slice_run):
    """The free-running trajectories: Adam's first steps are ~lr * sign(grad),
    so fp32 round-off in a gradient near zero flips that coordinate's update
    (0.52% of the generator's coordinates at step 1, 0.38% in SDT-BP) and the
    two sides' weights part a little more each step, as in
    tests/test_torch_port_train.py, whose bound the L1 takes: 1e-3. The GAN
    terms are left to the synced steps below (see the module docstring)."""
    for (jl, *_), (tl, *_) in zip(slice_run["jax"], slice_run["port"]):
        np.testing.assert_allclose(tl["G_reg_loss"], jl["G_reg_loss"], rtol=1e-3)


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("key", KEYS)
def test_synced_later_steps_match_jax(slice_run, step, key):
    """Steps 2 and 3 from JAX's state before each (Adam at counts 1 and 2,
    D's statistics moved three times a step before): step 1's tolerance."""
    np.testing.assert_allclose(slice_run["synced"][step][0][key],
                               slice_run["jax"][step][0][key], rtol=1e-4)


def _worst_rel(got, want):
    worst = 0.0
    for (gm, gv), (wm, wv) in zip(got, want):
        for g, w in ((gm, wm), (gv, wv)):
            worst = max(worst, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
    return worst


@pytest.mark.parametrize("step", range(STEPS))
def test_discriminator_statistics_track_jax(slice_run, step):
    """Three train-mode BN updates of D a step (real, fake, fake.detach()),
    per tensor by relative L2. JAX runs two forwards and reproduces the third
    update in closed form; the port runs the three. Step 1 from the same
    weights, steps 2 and 3 synced: 5e-4 (measured 1.0e-04 at step 1: D sees
    frame-to-frame differences of the prediction, which carry the
    prediction's 1.7e-05 round-off relative to smaller values)."""
    rel = _worst_rel((slice_run["port"] if step == 0 else slice_run["synced"])[step][1],
                     slice_run["jax"][step][1])
    print(f"step {step + 1}: D statistics, largest rel L2 {rel:.3e}")
    assert rel <= 5e-4, rel


@pytest.mark.parametrize("order", ["real_fake_fake", "fake_fake_real"])
def test_statistics_cadence_is_real_first(slice_run, order):
    """The reference's cadence, real then fake twice, meets the step-1 gate
    (5e-4); the same three forwards fake first leave other running statistics
    and fail it (measured 1.1e-01: EMA is order-dependent)."""
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram

    cfg, batch = slice_run["cfg"], slice_run["batch1"]
    parts = state_from_jax(slice_run["state0"])
    gen = build_model("SequenceGeneratorCNN", cfg, "cpu").train()
    gen.load_state_dict(parts["generator"])
    d = build_model("PoseSequenceDiscriminator", cfg, "cpu").train()
    d.load_state_dict(parts["discriminator"])

    with torch.no_grad():
        pred = gen(mel_spectrogram(batch["audio"]), 64, None)
        real, fake = disc_input(batch["poses"], cfg), disc_input(pred, cfg)
        for x in ((real, fake, fake) if order == "real_fake_fake" else (fake, fake, real)):
            d(x)
    rel = _worst_rel(_d_stats_port(d), slice_run["jax"][0][1])
    print(f"{order}: D statistics after step 1, largest rel L2 {rel:.3e}")
    assert (rel <= 5e-4) == (order == "real_fake_fake"), rel


def test_first_adam_step_of_the_discriminator_matches_jax(slice_run):
    """The first Adam update of every D coordinate, port against JAX, from the
    same weights, as tests/test_torch_port_train.py holds the generator's:
    lr * g / (|g| + eps), ~lr * sign(g). Coordinates whose update is below
    lr / 10 on both sides are left out; the rest part only where the gradient
    is near zero on a side (opposite signs, or below 0.999 lr, |g| < ~1e3
    eps, on one side at least: D's gradient carries the prediction's
    round-off through its frame differences), on at most 1% of a tensor. BN
    statistics are held by the test above, not here."""
    lr = slice_run["cfg"].TRAIN.LR
    before = state_from_jax(slice_run["state0"])["discriminator"]
    after_jax = state_from_jax(slice_run["state1"])["discriminator"]
    after_port = slice_run["first_update"]
    n = off = moved = 0
    for k, w0 in before.items():
        if not k.endswith(("weight", "bias")):
            continue
        w0 = w0.double()
        dj, dt = after_jax[k].double() - w0, after_port[k].double() - w0
        differ = ((dt - dj).abs() > 1e-2 * lr) & (torch.maximum(dt.abs(), dj.abs()) > 0.1 * lr)
        near_zero = (dt * dj <= 0) | (torch.minimum(dt.abs(), dj.abs()) < 0.999 * lr)
        assert near_zero[differ].all(), k
        assert differ.double().mean() <= 1e-2, (k, int(differ.sum()), w0.numel())
        n += w0.numel()
        off += int(differ.sum())
        moved += int((dj.abs() > 0.5 * lr).sum())
    print(f"discriminator: {n} coordinates, {moved} moved by > lr/2 in JAX; {off} updates "
          f"differ by > lr/100 ({off / n:.3e})")
    assert moved >= n // 2 and off <= 5e-3 * n


@pytest.mark.parametrize("step", range(STEPS))
def test_predictions_match_jax(slice_run, step):
    """Pixel-space predictions, relative L2: step 1 from the same weights,
    steps 2 and 3 synced: 5e-5 (measured 1.7e-05 at step 1: train-mode BN
    normalizes 21 layers by the statistics of a batch of 4 in fp32)."""
    got = (slice_run["port"] if step == 0 else slice_run["synced"])[step][2]
    want = slice_run["jax"][step][2]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"step {step + 1}: predictions rel L2 {rel:.3e}")
    assert rel <= 5e-5, rel


def test_eval_forward_after_a_train_step_matches_jax(slice_run):
    """The full-width BN generator in eval mode, at JAX's weights and running
    statistics after one train step (non-trivial: moved once from the init),
    on the same mel: rel L2 <= 1e-5."""
    import jax.numpy as jnp

    from speechdrivestemplates_tpu.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu_torch.models import build_model

    st1 = slice_run["state1"]
    parts = state_from_jax(st1)
    stats = parts["generator"]["audio_encoder.specgram_encoder_2d.0.0.norm.running_var"]
    assert not torch.equal(stats, torch.ones_like(stats))
    mel = np.asarray(mel_spectrogram(jnp.asarray(slice_run["batch1"]["audio"].numpy())))
    want, _ = slice_run["pipe"]._apply_generator(st1["params_g"], st1["batch_stats_g"],
                                                 jnp.asarray(mel), 64, None, False)
    gen = build_model("SequenceGeneratorCNN", slice_run["cfg"], "cpu")
    gen.load_state_dict(parts["generator"])
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), 64, None).numpy()
    want = np.asarray(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"eval forward after one step: rel L2 {rel:.3e}")
    assert got.shape == (4, 64, 2, 121) and rel <= 1e-5, rel


def test_checkpoint_keys_are_the_jax_export(slice_run, tmp_path):
    """The port's s2g .pth holds JAX ``export_voice2pose``'s keys for the same
    state: ``netD_pose.*``, no ``clips_code``; shapes agree."""
    from speechdrivestemplates_tpu.utils.torch_export import export_voice2pose

    ref = export_voice2pose(slice_run["state0"])
    path = str(tmp_path / "s2g.pth")
    slice_run["port_state"].save_checkpoint(path, epoch=1, step=3)
    msd = torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"]
    assert set(msd) == {f"module.{k}" for k in ref}
    assert "module.clips_code" not in msd and any(k.startswith("module.netD_pose.") for k in msd)
    for k, v in ref.items():
        assert tuple(msd[f"module.{k}"].shape) == np.shape(v), k


def test_port_checkpoint_loads_in_jax_and_back(slice_run, tmp_path):
    """A port .pth through JAX's ``load_torch_pth`` gives JAX the port's
    generator, discriminator and their statistics; a JAX export written as a
    .pth through the port's ``load_pth`` gives the port JAX's."""
    from speechdrivestemplates_tpu.utils.torch_export import export_voice2pose

    port, pipe = slice_run["port_state"], slice_run["pipe"]
    path = str(tmp_path / "port.pth")
    port.save_checkpoint(path, epoch=1, step=3)
    pipe.state = dict(slice_run["state0"])
    pipe.load_torch_pth(path)
    loaded = jax.device_get(pipe.state)
    want = port.state_dict()
    got = dict(params_from_jax(loaded["params_g"], loaded["batch_stats_g"]))
    got.update({f"netD_pose.{k}": v for k, v in discriminator_params_from_jax(
        loaded["params_d"], loaded["batch_stats_d"]).items()})
    for k, v in got.items():
        name = k if k.startswith("netD_pose.") else f"netG.{k}"
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[name].float(), rtol=0, atol=0, msg=name)

    ref = export_voice2pose(slice_run["state1"])
    jpath = str(tmp_path / "jax.pth")
    torch.save({"epoch": 1, "step": 1, "model_state_dict": {
        f"module.{k}": torch.from_numpy(np.array(v)) for k, v in ref.items()}}, jpath)
    fresh = Voice2PoseTrainState(slice_run["cfg"], 8, "cpu")
    fresh.load_pth(jpath)
    sd = fresh.state_dict()
    assert set(sd) == set(read_pth(jpath))
    for k, v in ref.items():
        torch.testing.assert_close(sd[k], torch.from_numpy(np.array(v)).to(sd[k].dtype),
                                   rtol=0, atol=0, msg=k)
