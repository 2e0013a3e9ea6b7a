"""Backward semantics and the learning-rate schedule of the port's SDT-BP
train step against the JAX package, on the CPU: the generator in train mode
plus its losses in float64, and MultiStepLR against the JAX step-indexed
schedule."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (generator_losses,
                                                                 make_scheduler)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _jax_cfg():
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.freeze()
    return cfg


def test_generator_and_kl_gradients_match_jax_in_float64(rng):
    """Backward semantics: the port's generator in train mode plus its losses
    (L1 to a random target, KL on random non-zero codes) against the JAX
    generator under x64, per tensor, for every generator tensor and the codes."""
    from speechdrivestemplates_tpu.models.generator import SequenceGeneratorCNN as JGen
    from speechdrivestemplates_tpu.pipelines.voice2pose import Voice2Pose
    from speechdrivestemplates_tpu_torch.models import SequenceGeneratorCNN
    from speechdrivestemplates_tpu_torch.utils import weights

    B, T, t_mel = 2, 32, 64
    mel = rng.randn(B, 80, t_mel)
    target = rng.randn(B, T, 2, 121)
    code = rng.randn(B, 32) * 0.5
    jcfg = _jax_cfg()
    with jax.enable_x64(True):
        gen = JGen(num_landmarks=121, code_dim=32, norm="IN", leaky=True, dtype=None)
        init = jax.jit(gen.init, static_argnums=(2, 4))
        params = init(jax.random.PRNGKey(0), jnp.zeros((1, 80, t_mel)), T,
                      jnp.zeros((1, 32)), True)["params"]
        params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        host = SimpleNamespace(cfg=jcfg, has_disc=False)

        def loss(p, c):
            pred = gen.apply({"params": p}, jnp.asarray(mel), T, c, True)
            return Voice2Pose._generator_losses(host, pred, jnp.asarray(target), c,
                                                None, True)[0]

        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params32)
        jg, jgc = jax.jit(jax.grad(loss, argnums=(0, 1)))(p64, jnp.asarray(code))
        jg = weights._module_from_jax(jax.device_get(jg), None,
                                      weights.reverse_generator, np.float64)
        jgc = np.asarray(jgc)

    model = SequenceGeneratorCNN(121, 32, dtype=torch.float64)
    model.load_state_dict(weights.params_from_jax(params32), strict=True)
    model.double().train()
    tcode = torch.from_numpy(code).requires_grad_(True)
    pred = model(torch.from_numpy(mel), T, tcode)
    g_loss, losses = generator_losses(pred, torch.from_numpy(target), tcode,
                                      sdt_bp(precision="fp32"))
    assert losses["G_clipcode_kl_loss"].item() != 0.0
    g_loss.backward()
    grads = dict(model.named_parameters())
    assert set(grads) == set(jg)
    for name, g_ref in jg.items():
        g = grads[name].grad.numpy()
        rel = np.linalg.norm(g - g_ref.numpy()) / np.linalg.norm(g_ref.numpy())
        assert rel <= 1e-6, (name, rel)
    rel = np.linalg.norm(tcode.grad.numpy() - jgc) / np.linalg.norm(jgc)
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("num_epochs,steps_per_epoch", [(100, 3), (12, 2), (10, 2), (5, 2)])
def test_lr_schedule_matches_jax(num_epochs, steps_per_epoch):
    """Per-step learning rates of the port's MultiStepLR, stepped at each
    epoch's end, against the JAX step-indexed schedule: the normal case, a
    milestone at 0 (N = 10) and a negative one (N = 5). optax evaluates its
    schedule in float32, hence rtol 1e-6."""
    from speechdrivestemplates_tpu.pipelines.voice2pose import _multistep_lr

    base = 1e-4
    cfg = apply_overrides(sdt_bp(), ["TRAIN.NUM_EPOCHS", str(num_epochs)])
    sched_ref = _multistep_lr(base, num_epochs, steps_per_epoch, True)
    param = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([param], lr=base)
    sched = make_scheduler(opt, cfg)
    got, want = [], []
    for epoch in range(num_epochs):
        for t in range(steps_per_epoch):
            got.append(opt.param_groups[0]["lr"])
            s = epoch * steps_per_epoch + t
            want.append(float(sched_ref(s)) if callable(sched_ref) else sched_ref)
            opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert make_scheduler(opt, apply_overrides(sdt_bp(), ["TRAIN.LR_SCHEDULER", "False"])) is None
