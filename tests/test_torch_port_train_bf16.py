"""One SDT-BP train step at TRAIN.PRECISION bf16, the port against the JAX
package, on the CPU: the same weights (a seeded JAX init), the same batch of 4
clips, the same random non-zero bank (so the clip-code KL is live). The two
packages round to bf16 in different places (the port takes IN statistics in
fp32 and applies BN's lrelu before the cast; JAX normalizes IN in bf16), so
the losses agree to bf16 precision, not to fp32's, and the gradients are held
by their direction."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                 train_step)
from speechdrivestemplates_tpu_torch.utils.weights import params_from_jax, state_from_jax

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module")
def bf16_step(tmp_path_factory):
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu.pipelines import get_pipeline
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    root = str(tmp_path_factory.mktemp("bf16") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=8, num_dev=0)
    jcfg = get_cfg_defaults()
    jcfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    jcfg.merge_from_list(["DATASET.ROOT_DIR", root, "DATASET.SPEAKER", "oliver",
                          "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False",
                          "TRAIN.SAVE_VIDEO", "False", "TRAIN.LR_SCHEDULER", "False",
                          "TRAIN.PRECISION", "bf16", "SYS.MESH.DATA", "1"])
    jcfg.freeze()
    pipe = get_pipeline("Voice2Pose")(jcfg)
    pipe.setup_dataset(jcfg, "train")
    pipe.setup_model(jcfg)
    bank = (np.random.RandomState(1).randn(8, 32) * 0.5).astype(np.float32)
    state = dict(jax.device_get(pipe.state), clips_code=bank)
    pipe.train_dataloader.set_epoch(1)
    jb = next(iter(pipe.train_dataloader))

    def loss(params_g):
        mel = mel_spectrogram(jnp.asarray(jb["audio"]), impl=jcfg.SYS.MEL_IMPL)
        code = jnp.asarray(bank)[jnp.asarray(jb["clip_index"])]
        pred, _ = pipe._apply_generator(params_g, state["batch_stats_g"], mel, 64, code, True)
        return pipe._generator_losses(pred, jnp.asarray(jb["poses"]), code, None, True)

    (_, jl), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(state["params_g"])
    cfg = apply_overrides(sdt_bp(precision="bf16"), [
        "DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4",
        "TRAIN.LR_SCHEDULER", "False", "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"])
    loader = train_loader(cfg)
    port = Voice2PoseTrainState(cfg, 8, "cpu")
    port.load(state_from_jax(state))
    loader.batch_sampler.set_epoch(1)
    tb = next(iter(loader))
    np.testing.assert_array_equal(tb["clip_index"].numpy(), jb["clip_index"])
    tl, _ = train_step(port, tb)  # the gradients stay on the parameters after the step
    return dict(jax={k: float(v) for k, v in jl.items()},
                port={k: float(v) for k, v in tl.items()},
                jax_grads=params_from_jax(jax.device_get(jg)),
                port_grads={k: p.grad for k, p in port.generator.named_parameters()})


@pytest.mark.parametrize("key,rtol", [("G_reg_loss", 1e-4), ("G_clipcode_kl_loss", 1e-5),
                                      ("G_loss", 1e-4)])
def test_bf16_step_losses_match_jax(bf16_step, key, rtol):
    """The L1 (a mean over 4 x 64 x 242 bf16 predictions) within 1e-4
    relative (measured 3.2e-06); the KL, computed in fp32 from the fp32 bank
    on both sides, within 1e-5 (measured 1.5e-07)."""
    got, want = bf16_step["port"][key], bf16_step["jax"][key]
    print(f"{key}: port {got:.7f}, JAX {want:.7f}, rel {abs(got - want) / abs(want):.3e}")
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_bf16_step_gradients_match_jax(bf16_step):
    """The generator's gradient, all tensors flattened together, at cosine
    >= 0.99 (measured 0.996224; the gate chip_smoke.py holds the card's bf16
    step to against its fp32 step), and every tensor's own at >= 0.95
    (measured 0.9639 at least, the first stem conv, whose gradient sums the
    most bf16 products)."""
    jg, tg = bf16_step["jax_grads"], bf16_step["port_grads"]
    assert set(jg) == set(tg)
    cos = torch.nn.functional.cosine_similarity
    whole = float(cos(torch.cat([tg[k].double().flatten() for k in jg]),
                      torch.cat([jg[k].double().flatten() for k in jg]), dim=0))
    each = {k: float(cos(tg[k].double().flatten(), jg[k].double().flatten(), dim=0)) for k in jg}
    worst = min(each, key=each.get)
    print(f"gradient cosine {whole:.6f}; lowest per tensor {each[worst]:.4f} ({worst})")
    assert whole >= 0.99
    assert each[worst] >= 0.95, (worst, each[worst])
