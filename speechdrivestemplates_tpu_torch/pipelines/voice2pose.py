"""The SDT-BP train step: mel -> generator -> L1 + clip-code KL -> Adam.

Counterpart of the JAX package's ``Voice2Pose._train_step_body``
(``pipelines/voice2pose.py``), for the SDT-BP configuration: a
``SequenceGeneratorCNN`` with a learned bank of per-clip template codes, and
the frozen ``PoseSeqEncoder`` whose train-mode BatchNorm statistics drift
with every step (its FGD features are evaluated later with them).

One step, in order (``train_step``):
  1. the mel spectrogram of the batch's audio (the CUDA kernel on the card;
     audio takes no gradient);
  2. the generator in train mode (its stem as plain cuDNN convs under
     autograd), with codes ``clips_code[clip_index]``;
  3. L1 x LAMBDA_REG, plus the KL of the codes' batch statistics to N(0, 1)
     x LAMBDA_CLIP_KL, skipped while any code variance is exactly 0 (the first
     steps after the bank's zero init);
  4. backward, then torch Adam steps: the generator with TRAIN.WD as L2 added
     to the gradient, the bank at LR x LR_SCALING with no decay (its gradient
     is dense, so rows not in the batch move by their moments);
  5. the pose encoder in train mode under ``no_grad`` on the prediction, then
     on the ground truth: two BN statistics updates, no parameter update;
  6. L2 and lip-sync metrics on pixel-space poses.
The learning rates follow MultiStepLR at epochs [N-10, N-2], gamma 0.1, when
TRAIN.LR_SCHEDULER is set (``make_scheduler``; ``end_epoch`` steps it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models import build_model
from ..ops.mel import _mel_filterbank_np, mel_spectrogram, mel_spectrogram_plain
from ..ops.pose import get_final_results, step_metrics
from ..utils.device import resolve_device

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for the Voice2Pose options this port lacks."""
    gcfg = cfg.VOICE2POSE.GENERATOR
    todo = {
        "VOICE2POSE.POSE_DISCRIMINATOR.NAME (the s2g-GAN discriminator)":
            (cfg.VOICE2POSE.POSE_DISCRIMINATOR.NAME is not None, 11),
        "VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION None (a code-less generator, s2g)":
            (gcfg.CLIP_CODE.DIMENSION is None, 11),
        "VOICE2POSE.GENERATOR.CLIP_CODE.EXTERNAL_CODE (SDT-VAE's Pose2Pose bank)":
            (gcfg.CLIP_CODE.EXTERNAL_CODE, 12),
        "VOICE2POSE.GENERATOR.CLIP_CODE.FRAME_VARIANT (per-frame codes)":
            (gcfg.CLIP_CODE.FRAME_VARIANT, 12),
    }
    for what, (on, item) in todo.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue A, "
                                      f"item {item}")


def make_scheduler(optimizer: torch.optim.Optimizer, cfg):
    """MultiStepLR at epochs [N-10, N-2], gamma 0.1 (stepped at each epoch's
    end), or None when TRAIN.LR_SCHEDULER is off. torch's semantics: a
    milestone at 0 scales the rate from the first step, a negative one never
    fires."""
    if not cfg.TRAIN.LR_SCHEDULER:
        return None
    n = cfg.TRAIN.NUM_EPOCHS
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones=[n - 10, n - 2],
                                                gamma=0.1)


class Voice2PoseTrainState:
    """The trained modules, their optimizers and schedulers, and the step count
    (the JAX package's ``Voice2Pose.state``). Weights come from a
    ``torch.Generator`` seeded with SYS.SEED; the bank starts at zero."""

    def __init__(self, cfg, num_train: int, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.SYS.SEED)
        gcfg = cfg.VOICE2POSE.GENERATOR
        self.generator = build_model(gcfg.NAME, cfg, self.device, generator=gen).train()
        self.clips_code = nn.Parameter(torch.zeros(num_train, gcfg.CLIP_CODE.DIMENSION,
                                                   device=self.device))
        self.pose_encoder = None
        if cfg.VOICE2POSE.POSE_ENCODER.NAME is not None:
            self.pose_encoder = build_model(cfg.VOICE2POSE.POSE_ENCODER.NAME, cfg,
                                            self.device, generator=gen)
            self.pose_encoder.train().requires_grad_(False)
        self.opt_g = torch.optim.Adam(self.generator.parameters(), lr=cfg.TRAIN.LR,
                                      weight_decay=cfg.TRAIN.WD, **ADAM)
        self.opt_code = torch.optim.Adam([self.clips_code],
                                         lr=cfg.TRAIN.LR * gcfg.CLIP_CODE.LR_SCALING, **ADAM)
        self.schedulers = [s for s in (make_scheduler(o, cfg)
                                       for o in (self.opt_g, self.opt_code)) if s]
        self.step = 0

    def load(self, parts: Dict[str, object]) -> None:
        """Load ``{"generator", "clips_code", "pose_encoder"}`` (the form of
        ``utils.weights.state_from_jax``), strictly."""
        self.generator.load_state_dict(parts["generator"], strict=True)
        bank = parts["clips_code"]
        if tuple(bank.shape) != tuple(self.clips_code.shape):
            raise ValueError(f"clip-code bank {tuple(bank.shape)}: this train split needs "
                             f"{tuple(self.clips_code.shape)} (one code per clip)")
        with torch.no_grad():
            self.clips_code.copy_(bank)
        if self.pose_encoder is not None:
            self.pose_encoder.load_state_dict(parts["pose_encoder"], strict=True)

    def end_epoch(self) -> None:
        for s in self.schedulers:
            s.step()

    def learning_rates(self) -> Dict[str, float]:
        return {"G": self.opt_g.param_groups[0]["lr"],
                "ClipCode": self.opt_code.param_groups[0]["lr"]}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The reference ``Voice2PoseModel`` keys (without ``module.``): the mel
        buffers, ``netG.*``, ``clips_code`` and ``pose_encoder.*``."""
        sd = {"mel_transfm.spectrogram.window":
                  torch.from_numpy(np.hanning(401)[:400].astype(np.float32)),
              "mel_transfm.mel_scale.fb":
                  torch.from_numpy(_mel_filterbank_np(16000, 512, 80, 55.0, 7500.0))}
        sd.update({f"netG.{k}": v for k, v in self.generator.state_dict().items()})
        sd["clips_code"] = self.clips_code.detach()
        if self.pose_encoder is not None:
            sd.update({f"pose_encoder.{k}": v
                       for k, v in self.pose_encoder.state_dict().items()})
        return sd

    def save_checkpoint(self, path: str, epoch: int, step: int) -> None:
        """The reference checkpoint layout: ``{epoch, step, model_state_dict}``
        with every key under ``module.``."""
        torch.save({"epoch": int(epoch), "step": int(step),
                    "model_state_dict": {f"module.{k}": v.detach().cpu()
                                         for k, v in self.state_dict().items()}}, path)


def generator_losses(pred: torch.Tensor, gt: torch.Tensor, code: torch.Tensor,
                     cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(G_loss, {"G_reg_loss", "G_clipcode_kl_loss", "G_loss"})`` for a
    prediction, its target and the batch's (B, code_dim) codes."""
    gcfg = cfg.VOICE2POSE.GENERATOR
    reg = (pred - gt).abs().mean() * gcfg.LAMBDA_REG
    mu, var = code.mean(0), code.var(0, correction=1)
    safe = torch.where(var > 0, var, torch.ones_like(var))
    kl = 0.5 * (-torch.log(safe) + mu ** 2 + var - 1.0).mean() * gcfg.LAMBDA_CLIP_KL
    kl = torch.where((var != 0).all(), kl, torch.zeros_like(kl))
    g_loss = reg + kl
    return g_loss, {"G_reg_loss": reg, "G_clipcode_kl_loss": kl, "G_loss": g_loss}


def train_step(state: Voice2PoseTrainState, batch: Dict[str, object],
               plain: bool = False) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """One optimization step on a batch of ``datasets.gesture_dataset``;
    returns ``(losses, results)`` as device tensors (no host sync). ``plain``
    takes the mel's plain version even on the card (a reference)."""
    cfg, dev = state.cfg, state.device
    audio = batch["audio"].to(dev, non_blocking=True)
    gt = batch["poses"].to(dev, non_blocking=True)
    index = batch["clip_index"].to(dev, non_blocking=True)
    stat = {k: v.to(dev, non_blocking=True) for k, v in batch["speaker_stat"].items()}

    mel = (mel_spectrogram_plain if plain else mel_spectrogram)(audio)
    code = state.clips_code[index]
    pred = state.generator(mel, cfg.DATASET.NUM_FRAMES, code)
    g_loss, losses = generator_losses(pred, gt, code, cfg)
    state.opt_g.zero_grad(set_to_none=True)
    state.opt_code.zero_grad(set_to_none=True)
    g_loss.backward()
    state.opt_g.step()
    state.opt_code.step()

    losses = {k: v.detach() for k, v in losses.items()}
    results: Dict[str, object] = {}
    with torch.no_grad():
        pred = pred.detach()
        if state.pose_encoder is not None:
            mu_p, lv_p = state.pose_encoder(pred)
            mu_g, lv_g = state.pose_encoder(gt)
            results.update(mu_pred=mu_p, logvar_pred=lv_p, mu_gt=mu_g, logvar_gt=lv_g)
        final = [get_final_results(p, stat["mean"], stat["std"], stat["scale_factor"],
                                   cfg.DATASET.HIERARCHICAL_POSE, cfg.DATASET.NUM_LANDMARKS)
                 for p in (pred, gt)]
        losses.update(step_metrics(*final))
    results.update(poses_pred_batch=final[0], poses_gt_batch=final[1])
    state.step += 1
    return losses, results
