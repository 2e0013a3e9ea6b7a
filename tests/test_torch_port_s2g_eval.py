"""s2g-GAN's bf16 train step and its test-only path, the port against the
JAX package, on the CPU.

One bf16 step from the same seeded weights on the same batch of 4 clips: the
losses, and the generator's and the discriminator's gradients by direction
(the two packages round to bf16 in different places, as
tests/test_torch_port_train_bf16.py states for SDT-BP). The BN generator's
bf16 gradient is far from its fp32 gradient in both packages (cosine 0.881
in JAX, 0.853 in the port, here; the port's 0.813 at B = 32), where SDT-BP's
IN generator keeps 0.996: train-mode BN subtracts the batch's mean gradient,
and what is left of each encoder conv's weight gradient is a small remainder
of bf16-rounded terms. So the gradients are held by how close each package's
bf16 gradient comes to the fp32 gradient of the same step, not to each other.

Then ``--test_only`` of one s2g ``.pth`` by both packages on 72 dev clips
(TEST.BATCH_SIZE 8: one compiled eval step in JAX, whose ragged last batch
tests/test_torch_port_eval.py holds; 72 latents keep the 64-wide FGD
covariances of full rank): a code-less generator draws no code, so nothing
needs fixing between the two.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, s2g
from speechdrivestemplates_tpu_torch.pipelines import trainer
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                 train_step)
from speechdrivestemplates_tpu_torch.utils.weights import (discriminator_params_from_jax,
                                                           params_from_jax, state_from_jax)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
NUM_DEV = 72


def _jax_cfg(root, *opts):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_s2g.yaml"))
    cfg.merge_from_list(["DATASET.ROOT_DIR", root, "DATASET.SPEAKER", "oliver",
                         "SYS.MESH.DATA", "1", "SYS.NUM_WORKERS", "0", *opts])
    cfg.freeze()
    return cfg


def _opts(root, out, *extra):
    return ["DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", out, "SYS.NUM_WORKERS", "0",
            "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "8", "TRAIN.SAVE_VIDEO", "False",
            "TEST.SAVE_VIDEO", "False", "TEST.SAVE_NPZ", "False", "TRAIN.VALIDATE", "False",
            "TRAIN.LR_SCHEDULER", "False", "SYS.LOG_INTERVAL", "1000", *extra]


@pytest.fixture(scope="module")
def speaker_root(tmp_path_factory):
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker

    root = str(tmp_path_factory.mktemp("s2g_eval") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=NUM_DEV, seed=7)
    return root


@pytest.fixture(scope="module")
def bf16_step(speaker_root):
    """JAX's bf16 G and D losses and gradients at its seeded init, from the
    pipeline's own loss functions (G through D in train mode; D on the
    detached prediction), and the port's bf16 and fp32 ``train_step`` at
    those weights on the same batch (the gradients stay on the parameters)."""
    from speechdrivestemplates_tpu.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    jcfg = _jax_cfg(speaker_root, "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False",
                    "TRAIN.SAVE_VIDEO", "False", "TRAIN.LR_SCHEDULER", "False",
                    "TRAIN.PRECISION", "bf16")
    pipe = get_pipeline("Voice2Pose")(jcfg)
    pipe.setup_dataset(jcfg, "train")
    pipe.setup_model(jcfg)
    state = jax.device_get(pipe.state)
    pipe.train_dataloader.set_epoch(1)
    jb = next(iter(pipe.train_dataloader))
    real = jnp.asarray(jb["poses"])

    def g_loss(params_g):
        mel = mel_spectrogram(jnp.asarray(jb["audio"]), impl=jcfg.SYS.MEL_IMPL)
        pred, _ = pipe._apply_generator(params_g, state["batch_stats_g"], mel, 64, None, True)
        loss, losses = pipe._generator_losses(
            pred, real, None, (state["params_d"], state["batch_stats_d"]), True)
        return loss, (losses, pred)

    (_, (jl, pred)), jg = jax.jit(jax.value_and_grad(g_loss, has_aux=True))(state["params_g"])

    def d_loss(params_d):
        return pipe._disc_losses(params_d, state["batch_stats_d"], jax.lax.stop_gradient(pred),
                                 real, True)

    (_, (jd, _)), jgd = jax.jit(jax.value_and_grad(d_loss, has_aux=True))(state["params_d"])
    ports, losses = {}, {}
    for precision in ("bf16", "fp32"):
        cfg = apply_overrides(s2g(precision=precision), _opts(speaker_root, "unused"))
        loader = trainer.train_loader(cfg)
        ports[precision] = Voice2PoseTrainState(cfg, 8, "cpu")
        ports[precision].load(state_from_jax(state))
        loader.batch_sampler.set_epoch(1)
        tb = next(iter(loader))
        np.testing.assert_array_equal(tb["clip_index"].numpy(), jb["clip_index"])
        losses[precision], _ = train_step(ports[precision], tb)

    def grads(part, jax_grads, stats, to_torch):
        return {"jax": {k: v for k, v in to_torch(jax.device_get(jax_grads), stats).items()
                        if "running" not in k and "num_batches" not in k},
                **{p: {k: t.grad for k, t in getattr(ports[p], part).named_parameters()}
                   for p in ports}}

    return dict(jax={k: float(v) for k, v in dict(jl, **jd).items()},
                port={k: float(v) for k, v in losses["bf16"].items()},
                grads={"generator": grads("generator", jg, state["batch_stats_g"],
                                          params_from_jax),
                       "discriminator": grads("discriminator", jgd, state["batch_stats_d"],
                                              discriminator_params_from_jax)})


@pytest.mark.parametrize("key,rtol", [("G_reg_loss", 1e-4), ("G_loss", 1e-4),
                                      ("G_pose_gan_loss", 2e-2), ("D_pose_gan_loss", 2e-2)])
def test_bf16_step_losses_match_jax(bf16_step, key, rtol):
    """The L1 (a mean over 4 x 64 x 242 bf16 predictions) and G_loss within
    1e-4 relative, the gate of tests/test_torch_port_train_bf16.py. The GAN
    terms are means of 4 x 15 bf16 scores of the discriminator, squared in
    bf16 on both sides, and the two packages round its BN outputs at other
    points (the port applies the leaky ReLU before the cast): 2e-2."""
    got, want = bf16_step["port"][key], bf16_step["jax"][key]
    print(f"{key}: port {got:.7f}, JAX {want:.7f}, rel {abs(got - want) / abs(want):.3e}")
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("part,margin", [("generator", 0.05), ("discriminator", 0.02)])
def test_bf16_step_gradients_match_jax(bf16_step, part, margin):
    """Each network's bf16 gradient against the port's fp32 gradient of the
    same step (which is JAX's fp32 gradient to round-off:
    tests/test_torch_port_s2g_train.py): the port's cosine, all tensors
    flattened together, within ``margin`` of JAX's (measured: generator
    0.853 against 0.881, discriminator 0.9855 against 0.9909), and its lowest
    per-tensor cosine within 2 x ``margin`` of JAX's lowest (0.748 against
    0.667, both the first encoder layer's BN bias; 0.951 against 0.963, both
    D's first BN bias)."""
    g = bf16_step["grads"][part]
    keys = sorted(g["fp32"])
    assert set(g["jax"]) == set(g["bf16"]) == set(keys)
    assert all(v is not None for v in g["bf16"].values())
    cos = torch.nn.functional.cosine_similarity

    def to_fp32(side, ks):
        return float(cos(torch.cat([g[side][k].double().flatten() for k in ks]),
                         torch.cat([g["fp32"][k].double().flatten() for k in ks]), dim=0))

    whole = {side: to_fp32(side, keys) for side in ("bf16", "jax")}
    lowest = {side: min(to_fp32(side, [k]) for k in keys) for side in ("bf16", "jax")}
    print(f"{part}: cosine to fp32, port {whole['bf16']:.6f}, JAX {whole['jax']:.6f}; "
          f"lowest per tensor, port {lowest['bf16']:.4f}, JAX {lowest['jax']:.4f}")
    assert whole["bf16"] >= whole["jax"] - margin
    assert lowest["bf16"] >= lowest["jax"] - 2 * margin


@pytest.fixture(scope="module")
def test_run(speaker_root, tmp_path_factory):
    """Two fp32 s2g train steps by the port (so every BN statistic, the
    frozen encoder's included, has moved), its .pth, then ``--test_only`` of
    it by both packages."""
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    out = str(tmp_path_factory.mktemp("s2g_test_out"))
    cfg = apply_overrides(s2g(precision="fp32"), _opts(speaker_root, out))
    loader = trainer.train_loader(cfg)
    state = Voice2PoseTrainState(cfg, len(loader.dataset), "cpu")
    loader.batch_sampler.set_epoch(1)
    for b in loader:
        train_step(state, b)
    pth = os.path.join(out, "s2g.pth")
    state.save_checkpoint(pth, 1, 2)
    port = trainer.test(cfg, pth, "t", "cpu")
    jcfg = _jax_cfg(speaker_root, "SYS.OUTPUT_DIR", out, "TEST.BATCH_SIZE", "8",
                    "TEST.SAVE_VIDEO", "False", "TEST.SAVE_NPZ", "False")
    jax_metrics = {k: float(v) for k, v in
                   get_pipeline("Voice2Pose")(jcfg).test(jcfg, "t", pth).items()}
    return dict(port=port, jax=jax_metrics)


@pytest.mark.parametrize("key", ["L2_dist", "lip_sync_error_n", "G_reg_loss",
                                 "G_pose_gan_loss", "D_pose_gan_loss"])
def test_test_only_metrics_match_jax(test_run, key):
    """Epoch means over 72 clips, the GAN terms with D in eval mode: rtol
    1e-4, the gate of tests/test_torch_port_eval.py."""
    assert test_run["port"]["num_samples"] == NUM_DEV
    assert set(test_run["port"]["metrics"]) == set(test_run["jax"])
    np.testing.assert_allclose(test_run["port"]["metrics"][key], test_run["jax"][key],
                               rtol=1e-4)


@pytest.mark.parametrize("key", ["FGD_mu", "FGD_mu_logvar"])
def test_test_only_fgd_matches_jax(test_run, key):
    """FGD of the frozen encoder's latents of ``p2g_renorm``'d poses: rtol
    1e-3, the gate of tests/test_torch_port_eval.py."""
    got, want = test_run["port"]["metrics"][key], test_run["jax"][key]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
