"""The port's Pose2Pose VAE against the JAX package's, on the CPU.

The JAX ``Pose2Pose`` pipeline is built on a synthetic speaker (8 clips, batch
4, full width, fp32); the port gets its weights (``utils.weights.
pose2pose_state_from_jax``) and reads the same directory with its own loader.
The reparameterization noise is the JAX step's own draw from its ``'reparam'``
stream, handed to the port through the ``noise`` argument.
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose
from speechdrivestemplates_tpu_torch.pipelines.pose2pose import (Pose2PoseTrainState,
                                                                eval_step, pose2pose_losses,
                                                                train_step)
from speechdrivestemplates_tpu_torch.utils.weights import (autoencoder_params_from_jax,
                                                          pose2pose_state_from_jax)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
B, CODE = 4, 32


def _jax_cfg(root, **overrides):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "pose2pose.yaml"))
    cfg.DATASET.SPEAKER = "oliver"
    cfg.DATASET.ROOT_DIR = root
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TRAIN.VALIDATE = False
    cfg.TRAIN.SAVE_VIDEO = False
    cfg.TRAIN.LR_SCHEDULER = False
    cfg.SYS.MESH.DATA = 1
    for k, v in overrides.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    cfg.freeze()
    return cfg


def _port_cfg(root, *opts):
    return apply_overrides(pose2pose(), [
        "DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", str(B),
        "TRAIN.LR_SCHEDULER", "False", "TRAIN.VALIDATE", "False",
        "TRAIN.SAVE_VIDEO", "False", *opts])


def _pinned_noise(pipe, state, rng, n, dtype=jnp.float32):
    """Exactly the noise the JAX autoencoder draws from its 'reparam' stream."""
    return np.asarray(pipe.ae.apply(
        {"params": state["params_ae"], "batch_stats": state["batch_stats_ae"]},
        method=lambda m: jax.random.normal(m.make_rng("reparam"), (n, CODE), dtype),
        rngs={"reparam": rng}))


def _jax_batch(batch):
    return {k: batch[k] for k in ("poses", "clip_index", "speaker_stat")}


@pytest.fixture(scope="module")
def p2p(tmp_path_factory):
    """One train step of the JAX pipeline and of the port from the same
    weights, on the same batch, with the same noise."""
    from speechdrivestemplates_tpu.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    root = str(tmp_path_factory.mktemp("p2p") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=0)
    jcfg = _jax_cfg(root)
    pipe = get_pipeline("Pose2Pose")(jcfg)
    pipe.setup_dataset(jcfg, "train")
    pipe.setup_model(jcfg)
    pipe.setup_optimizer()
    state0 = jax.device_get(pipe.state)

    cfg = _port_cfg(root)
    loader = train_loader(cfg)
    port = Pose2PoseTrainState(cfg, len(loader.dataset), "cpu")
    port.load(pose2pose_state_from_jax(state0))

    pipe.train_dataloader.set_epoch(1)
    jb = next(iter(pipe.train_dataloader))
    loader.batch_sampler.set_epoch(1)
    tb = next(iter(loader))
    np.testing.assert_array_equal(tb["clip_index"].numpy(), jb["clip_index"])
    rng = jax.random.PRNGKey(7)
    noise = _pinned_noise(pipe, state0, rng, B)
    jstate, jl, jr = pipe._get_step("train")(pipe.state, pipe._device_batch(jb), rng)
    pipe.state = jstate
    tl, tr = train_step(port, tb, noise=torch.from_numpy(noise))
    return SimpleNamespace(root=root, jcfg=jcfg, pipe=pipe, cfg=cfg, port=port, jb=jb, tb=tb,
                           state0=state0, state1=jax.device_get(jstate), noise=noise,
                           jax_losses={k: float(v) for k, v in jl.items()},
                           jax_results=jax.device_get(jr),
                           port_losses={k: float(v) for k, v in tl.items()},
                           port_results=tr)


def _fresh_port_ae(p2p, state):
    port = Pose2PoseTrainState(p2p.cfg, 8, "cpu")
    port.load(pose2pose_state_from_jax(state))
    return port.ae


@pytest.mark.parametrize("train", [False, True])
def test_decoder_matches_jax(p2p, rng, train):
    """The decoder alone on random codes, at the weights and statistics after
    one step (BN train mode: batch statistics; eval mode: running ones)."""
    from speechdrivestemplates_tpu.models.autoencoder import PoseSeqDecoder as JDec

    code = rng.randn(B, CODE).astype(np.float32)
    jm = JDec(num_landmarks=121, code_dim=CODE, norm="BN", leaky=True)
    variables = {"params": p2p.state1["params_ae"]["decoder"],
                 "batch_stats": p2p.state1["batch_stats_ae"]["decoder"]}
    if train:
        want, _ = jm.apply(variables, jnp.asarray(code), True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(code), False)
    dec = _fresh_port_ae(p2p, p2p.state1).decoder.train(train)
    with torch.no_grad():
        got = dec(torch.from_numpy(code)).transpose(1, 2).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (B, 64, 242)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("train", [False, True])
def test_autoencoder_matches_jax(p2p, train):
    """Encode, reparameterize with the JAX draw, decode, at the weights and
    statistics after one step; and the running statistics a train-mode
    forward leaves. Elementwise within rtol 1e-5 plus an atol of 1e-5 of the
    largest value in eval mode (measured: 6.1e-05 of 20.3 at most, pred), 2e-5
    in train mode, where the statistics of the deep, short layers (2 to 8
    positions x 4 samples) amplify fp32 round-off (measured 5.1e-05 of 3.28,
    relative L2 1.25e-05)."""
    poses = np.asarray(p2p.jb["poses"])
    rng = jax.random.PRNGKey(11)
    noise = _pinned_noise(p2p.pipe, p2p.state1, rng, B)
    variables = {"params": p2p.state1["params_ae"],
                 "batch_stats": p2p.state1["batch_stats_ae"]}
    if train:
        (pred, mu, lv), upd = p2p.pipe.ae.apply(variables, jnp.asarray(poses), 64, None, True,
                                                rngs={"reparam": rng}, mutable=["batch_stats"])
    else:
        pred, mu, lv = p2p.pipe.ae.apply(variables, jnp.asarray(poses), 64, None, False,
                                         rngs={"reparam": rng})
    ae = _fresh_port_ae(p2p, p2p.state1).train(train)
    with torch.no_grad():
        got = ae(torch.from_numpy(poses), 64, noise=torch.from_numpy(noise))
    assert got[0].shape == (B, 64, 2, 121) and got[1].shape == got[2].shape == (B, CODE)
    for name, g, w in zip(("pred", "mu", "logvar"), got, (pred, mu, lv)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=(2e-5 if train else 1e-5) * np.abs(w).max(),
                                   err_msg=name)
    if train:
        want = autoencoder_params_from_jax(p2p.state1["params_ae"],
                                           jax.device_get(upd["batch_stats"]))
        for k, v in ae.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                rel = float(torch.linalg.norm(v - want[k]) / torch.linalg.norm(want[k]))
                assert rel <= 1e-5, (k, rel)


def test_external_code_bypasses_the_encoder(p2p, rng):
    """A given code is decoded as is, returned as mu, with a zero logvar."""
    code = rng.randn(B, CODE).astype(np.float32)
    want, mu, lv = p2p.pipe.ae.apply({"params": p2p.state1["params_ae"],
                                      "batch_stats": p2p.state1["batch_stats_ae"]},
                                     None, 64, jnp.asarray(code), False)
    ae = _fresh_port_ae(p2p, p2p.state1).eval()
    with torch.no_grad():
        got, tmu, tlv = ae(None, 64, external_code=torch.from_numpy(code))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert torch.equal(tmu, torch.from_numpy(code)) and not tlv.any()


@pytest.mark.parametrize("key", ["reg_loss", "kl_loss", "loss", "L2_dist", "lip_sync_error_n"])
def test_first_step_losses_match_jax(p2p, key):
    np.testing.assert_allclose(p2p.port_losses[key], p2p.jax_losses[key], rtol=1e-4)


@pytest.mark.parametrize("bank", ["clip_code_mu", "clip_code_logvar"])
def test_first_step_scatters_the_bank(p2p, bank):
    """After one step the bank holds the step's mu (logvar) at the batch's
    clip_index, within rtol 1e-4 of JAX's (atol 1e-4 of the largest code, for
    codes near zero), and zero in every other row."""
    got = getattr(p2p.port, bank).numpy()
    want = np.asarray(p2p.state1[bank])
    idx = p2p.tb["clip_index"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got[idx], p2p.port_results[bank].numpy())
    rest = np.setdiff1d(np.arange(got.shape[0]), idx)
    assert len(rest) == 4 and not got[rest].any() and np.abs(got[idx]).min(1).max() > 0


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``. The JAX package's
    ``TorchBatchNorm`` takes its statistics in float32 whatever its input;
    standing this in for its module's ``jnp`` lifts them to float64, so that
    the float64 comparison holds semantics rather than float32 round-off."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_gradients_match_jax_in_float64(p2p, monkeypatch):
    """Backward semantics: the autoencoder in train mode plus both losses in
    float64, the JAX draw as noise, every tensor's gradient within 1e-6
    relative L2 of the JAX package's under x64."""
    from speechdrivestemplates_tpu.models import blocks as jblocks
    from speechdrivestemplates_tpu.pipelines.pose2pose import Pose2Pose
    from speechdrivestemplates_tpu_torch.models import Autoencoder

    monkeypatch.setattr(jblocks, "jnp", _Float64Numpy())
    poses = np.asarray(p2p.jb["poses"], np.float64)
    host = SimpleNamespace(cfg=p2p.jcfg)
    rng = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p2p.state0["params_ae"])
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             p2p.state0["batch_stats_ae"])
        noise = _pinned_noise(p2p.pipe, {"params_ae": params, "batch_stats_ae": stats},
                              rng, B, jnp.float64)

        def loss(p):
            (pred, mu, lv), _ = p2p.pipe.ae.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(poses), 64, None, True,
                rngs={"reparam": rng}, mutable=["batch_stats"])
            return Pose2Pose._losses(host, pred, jnp.asarray(poses), mu, lv)["loss"]

        jg = jax.device_get(jax.jit(jax.grad(loss))(params))
        jg = autoencoder_params_from_jax(jg, jax.device_get(stats))
    assert noise.dtype == np.float64
    ae = Autoencoder(121, CODE, "BN", True, dtype=torch.float64)
    ae.load_state_dict(autoencoder_params_from_jax(p2p.state0["params_ae"],
                                                   p2p.state0["batch_stats_ae"]))
    ae.double().train()
    gt = torch.from_numpy(poses)
    pred, mu, lv = ae(gt, 64, noise=torch.from_numpy(noise))
    pose2pose_losses(pred, gt, mu, lv, p2p.cfg)["loss"].backward()
    grads = dict(ae.named_parameters())
    assert set(grads) == {k for k in jg if not k.endswith(("running_mean", "running_var",
                                                            "num_batches_tracked"))}
    worst = 0.0
    for name, p in grads.items():
        want = jg[name].double().numpy()
        rel = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        worst = max(worst, rel)
        assert rel <= 1e-6, (name, rel)
    print(f"largest per-tensor gradient rel L2 {worst:.3e}")


def _jax_first_gradient(p2p):
    """The JAX gradient of the first step's loss at the pre-step weights."""
    from speechdrivestemplates_tpu.pipelines.pose2pose import Pose2Pose

    host = SimpleNamespace(cfg=p2p.jcfg)
    stats = p2p.state0["batch_stats_ae"]
    poses = jnp.asarray(p2p.jb["poses"])

    def loss(p):
        (pred, mu, lv), _ = p2p.pipe.ae.apply(
            {"params": p, "batch_stats": stats}, poses, 64, None, True,
            rngs={"reparam": jax.random.PRNGKey(7)}, mutable=["batch_stats"])
        return Pose2Pose._losses(host, pred, poses, mu, lv)["loss"]

    return jax.device_get(jax.jit(jax.grad(loss))(p2p.state0["params_ae"]))


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_first_adam_update_matches_jax(p2p, wd):
    """The first Adam update of every coordinate, port against JAX, on one
    gradient: the JAX gradient of the first step's loss goes through the JAX
    pipeline's optimizer (built by its ``setup_optimizer``) and, as ``.grad``,
    through the port's (built by ``Pose2PoseTrainState``). At TRAIN.WD 1e-3 the
    L2 term joins the gradient. Every coordinate's change agrees within 1e-4
    lr plus 2 ulps of the weight."""
    import optax

    from speechdrivestemplates_tpu.pipelines.voice2pose import _adam

    grads = _jax_first_gradient(p2p)
    lr = p2p.cfg.TRAIN.LR
    tx = _adam(lr, wd)
    upd, _ = tx.update(grads, tx.init(p2p.state0["params_ae"]), p2p.state0["params_ae"])
    want = autoencoder_params_from_jax(
        jax.device_get(optax.apply_updates(p2p.state0["params_ae"], upd)),
        p2p.state0["batch_stats_ae"])
    port = Pose2PoseTrainState(_port_cfg(p2p.root, "TRAIN.WD", str(wd)), 8, "cpu")
    port.load(pose2pose_state_from_jax(p2p.state0))
    before = {k: v.detach().clone() for k, v in port.ae.named_parameters()}
    g = autoencoder_params_from_jax(grads, p2p.state0["batch_stats_ae"])
    for k, p in port.ae.named_parameters():
        p.grad = g[k].clone()
    port.opt.step()
    worst = 0.0
    for k, p in port.ae.named_parameters():
        w0 = before[k].double()
        dt, dj = p.detach().double() - w0, want[k].double() - w0
        ulp = torch.from_numpy(np.spacing(np.abs(p.detach().numpy()))).double()
        err = float(((dt - dj).abs() - 2 * ulp).max()) / lr
        worst = max(worst, err)
        assert err <= 1e-4, (k, err)
        assert (dj.abs() > 0.5 * lr).double().mean() > 0.5, k  # the step moved the tensor
    print(f"wd {wd}: largest first-update difference beyond 2 ulps {worst:.3e} lr")


def test_first_step_updates_track_jax(p2p):
    """Each side's first step on its own gradient. Adam's first update is
    ~lr * sign(g), so coordinates part where the two fp32 gradients do: a
    leaky-ReLU input within round-off of 0 takes slope 1 on one side and 0.2
    on the other, which moves every gradient below it a little (one such
    element among a decoder layer's 65,536 moves the layer's fp32 gradient by
    ~3e-3 relative to float64), and with it the sign-like updates of the small
    gradients. The updates that differ by more than lr / 100 are at most 1%
    of each tensor and 0.5% of all coordinates (measured 0.14%); the
    gradients are held in float64 above and Adam on one gradient just
    before."""
    lr = p2p.cfg.TRAIN.LR
    before = autoencoder_params_from_jax(p2p.state0["params_ae"], p2p.state0["batch_stats_ae"])
    after = autoencoder_params_from_jax(p2p.state1["params_ae"], p2p.state1["batch_stats_ae"])
    n = off = moved = 0
    for k, p in p2p.port.ae.named_parameters():
        w0 = before[k].double()
        dj, dt = after[k].double() - w0, p.detach().double() - w0
        differ = ((dt - dj).abs() > 1e-2 * lr) & (torch.maximum(dt.abs(), dj.abs()) > 0.1 * lr)
        assert differ.double().mean() <= 1e-2, (k, int(differ.sum()), w0.numel())
        n += w0.numel()
        off += int(differ.sum())
        moved += int((dj.abs() > 0.5 * lr).sum())
    print(f"{n} coordinates, {moved} moved by > lr/2 in JAX; {off} updates differ ({off / n:.3e})")
    assert moved >= n // 2 and off <= 5e-3 * n


def test_eval_with_multiple_matches_jax(p2p):
    """The eval step at TEST.MULTIPLE 2 (the batch after itself, BN running
    statistics, the reparameterization still sampling), at the weights after
    one step: losses, metrics and the spread of the repeats' L2."""
    from speechdrivestemplates_tpu.pipelines.pose2pose import Pose2Pose

    rng = jax.random.PRNGKey(5)
    noise = _pinned_noise(p2p.pipe, p2p.state1, rng, 2 * B)
    mb = Pose2Pose.multiply_batch(_jax_batch(p2p.jb), 2)
    db, valid, sig = p2p.pipe._device_eval_batch(mb)
    jl, _ = p2p.pipe._get_step("eval", 2, valid, sig)(p2p.pipe.state, db, rng, None)
    cfg = copy.deepcopy(p2p.cfg)
    cfg.TEST.MULTIPLE = 2
    port = Pose2PoseTrainState(cfg, 8, "cpu")
    port.load(pose2pose_state_from_jax(p2p.state1))
    tl, tr = eval_step(port, p2p.tb, noise=torch.from_numpy(noise))
    assert set(tl) == set(jl) >= {"L2_dist_min", "L2_dist_max", "reg_loss", "kl_loss"}
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    assert float(tl["L2_dist_min"]) < float(tl["L2_dist"]) < float(tl["L2_dist_max"])
    assert tr["poses_pred_batch"].shape == (2 * B, 64, 2, 121)
    assert port.ae.training  # back in train mode after the eval step


def test_checkpoint_is_the_reference_layout_and_loads_in_jax(p2p, tmp_path):
    """The port's Pose2Pose .pth holds the keys of the JAX package's
    ``export_pose2pose`` under ``module.``; the JAX pipeline's
    ``load_torch_pth`` of it gives the port's eval losses."""
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu.utils.torch_export import export_pose2pose

    path = str(tmp_path / "p2p.pth")
    p2p.port.save_checkpoint(path, epoch=1, step=1)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (1, 1)
    ref = export_pose2pose(p2p.state1)
    assert set(ckpt["model_state_dict"]) == {f"module.{k}" for k in ref}
    for k, v in ref.items():
        assert tuple(ckpt["model_state_dict"][f"module.{k}"].shape) == np.shape(v), k

    pipe = get_pipeline("Pose2Pose")(p2p.jcfg)
    pipe.setup_dataset(p2p.jcfg, "train")
    pipe.setup_model(p2p.jcfg)
    pipe.load_torch_pth(path)
    rng = jax.random.PRNGKey(9)
    noise = _pinned_noise(pipe, pipe.state, rng, B)
    db, valid, sig = pipe._device_eval_batch(_jax_batch(p2p.jb))
    jl, _ = pipe._get_step("eval", 1, valid, sig)(pipe.state, db, rng, None)
    port = Pose2PoseTrainState(p2p.cfg, None, "cpu")
    port.load_pth(path)
    tl, _ = eval_step(port, p2p.tb, noise=torch.from_numpy(noise))
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(port.clip_code_mu.numpy(), p2p.port.clip_code_mu.numpy())
