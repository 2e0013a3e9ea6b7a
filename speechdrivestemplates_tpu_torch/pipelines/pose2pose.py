"""The Pose2Pose VAE: train step, eval step, checkpoint.

Counterpart of the JAX package's ``pipelines/pose2pose.py``: encode the
ground-truth poses, reparameterize, decode; L1 x LAMBDA_REG plus the
elementwise KL to N(0, 1) x LAMBDA_KL; Adam on the autoencoder (TRAIN.WD as
L2), MultiStepLR as for Voice2Pose. After each train step the per-clip banks
``clip_code_mu`` / ``clip_code_logvar`` (N_train, code_dim), zero at init and
never optimized, take the step's mu and logvar at the batch's ``clip_index``.
They persist in the checkpoint, whose encoder is Voice2Pose's frozen FGD
encoder (``VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT``) and whose ``clip_code_mu``
is SDT-VAE's template bank. The step runs poses only: no kernel. The demo
(``demo_step``) decodes an external code, ``np.load(DEMO.CODE_PATH)["v"][i] *
10``, as the reference and the JAX package do. Videos are drawn by
Voice2Pose's ``generate_video*``; the epoch figure ``train/clip_code`` is
``clip_code_mu``'s 2-D PCA. Under a process group the step is the global
batch's, as Voice2Pose's is: global losses and BN statistics, gradients
averaged over ranks, the reparameterization noise drawn for the global batch
on every rank (each takes its rows), and every rank's rows written into the
banks on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import build_model
from ..ops.pose import get_final_results, multiply_batch, step_metrics
from ..parallel import dist as pdist
from ..utils.device import resolve_device
from ..utils.weights import check_bank_rows, read_pth
from .voice2pose import (code_figure, eval_mode, load_train_state, make_adam, make_scheduler,
                         mel_buffers, save_pth, step_schedulers, train_state_dict)

DEVICE_KEYS = ("poses", "clip_index", "speaker_stat")


class Pose2PoseTrainState:
    """The autoencoder, its Adam and scheduler, the two banks and the step
    count (the JAX package's ``Pose2Pose.state``). Weights come from a
    ``torch.Generator`` seeded with SYS.SEED, the reparameterization noise from
    another on the device. ``num_train`` None (a test run) leaves the banks
    for a checkpoint to fill. ``capturable`` and loads as for
    ``Voice2PoseTrainState``."""

    def __init__(self, cfg, num_train: Optional[int], device="cuda",
                 capturable: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_train = num_train
        gen = torch.Generator().manual_seed(cfg.SYS.SEED)
        self.ae = build_model(cfg.POSE2POSE.AUTOENCODER.NAME, cfg, self.device,
                              generator=gen).train()
        shape = (num_train or 1, cfg.POSE2POSE.AUTOENCODER.CODE_DIM)
        self.clip_code_mu = torch.zeros(shape, device=self.device)
        self.clip_code_logvar = torch.zeros(shape, device=self.device)
        if capturable is None:
            capturable = self.device.type == "cuda" and cfg.TRAIN.STEPS_PER_DISPATCH > 1
        self.capturable = capturable
        self.opt = make_adam(self.ae.parameters(), cfg.TRAIN.LR, self.device, capturable,
                             cfg.TRAIN.WD)
        self.schedulers = [s for s in (make_scheduler(self.opt, cfg),) if s]
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.SYS.SEED)
        self.step = 0

    def load(self, parts: Dict[str, torch.Tensor]) -> None:
        """Load ``{"autoencoder", "clip_code_mu", "clip_code_logvar"}`` (the
        form of ``utils.weights.pose2pose_state_from_jax``), strictly."""
        self.ae.load_state_dict(parts["autoencoder"], strict=True)
        for k in ("clip_code_mu", "clip_code_logvar"):
            check_bank_rows(parts[k], self.num_train)
            bank = parts[k].float().to(self.device)
            if bank.shape == getattr(self, k).shape:
                getattr(self, k).copy_(bank)
            else:  # a test run takes the checkpoint's rows
                setattr(self, k, bank.clone())

    def load_pth(self, path: str) -> None:
        """Weights and banks from a reference-layout Pose2Pose checkpoint."""
        sd = read_pth(path)
        self.load({"autoencoder": {k[len("ae."):]: v for k, v in sd.items()
                                   if k.startswith("ae.")},
                   "clip_code_mu": sd["clip_code_mu"],
                   "clip_code_logvar": sd["clip_code_logvar"]})

    def optimizers(self) -> list:
        return [self.opt]

    def end_epoch(self) -> None:
        step_schedulers(self.schedulers, self.optimizers())

    def learning_rates(self) -> Dict[str, float]:
        return {"optimizer": float(self.opt.param_groups[0]["lr"])}

    def train_state_dict(self) -> Dict[str, object]:
        return train_state_dict(self)

    def load_train_state(self, sd: Dict[str, object]) -> None:
        load_train_state(self, sd)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The reference ``Pose2PoseModel`` keys (without ``module.``): the mel
        buffers, ``ae.*``, ``clip_code_mu`` and ``clip_code_logvar``."""
        sd = mel_buffers()
        sd.update({f"ae.{k}": v for k, v in self.ae.state_dict().items()})
        sd["clip_code_mu"], sd["clip_code_logvar"] = self.clip_code_mu, self.clip_code_logvar
        return sd

    def save_checkpoint(self, path: str, epoch: int, step: int) -> None:
        save_pth(path, self.state_dict(), epoch, step)


def pose2pose_losses(pred: torch.Tensor, gt: torch.Tensor, mu: torch.Tensor,
                     logvar: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """``{"reg_loss", "kl_loss", "loss"}``: L1 x LAMBDA_REG and the mean
    elementwise KL of N(mu, exp(logvar)) to N(0, 1) x LAMBDA_KL; under a
    process group, the global batch's means (``parallel.dist``)."""
    reg = pdist.mean_over_ranks((pred - gt).abs().mean()) * cfg.POSE2POSE.LAMBDA_REG
    kl = (pdist.mean_over_ranks(0.5 * (-logvar + mu ** 2 + logvar.exp() - 1.0).mean())
          * cfg.POSE2POSE.LAMBDA_KL)
    return {"reg_loss": reg, "kl_loss": kl, "loss": reg + kl}


def _final(batch, poses, cfg):
    stat = batch["speaker_stat"]
    return get_final_results(poses, stat["mean"], stat["std"], stat["scale_factor"],
                             cfg.DATASET.HIERARCHICAL_POSE, cfg.DATASET.NUM_LANDMARKS)


def _to(batch, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, non_blocking=True)
            for k, v in batch.items()}


def _global_noise(state: Pose2PoseTrainState, batch_size: int) -> Optional[torch.Tensor]:
    """Under a process group, the reparameterization's noise for a rank's
    shard: the global batch's draw from ``state.rng`` on every rank, this
    rank's rows of it (``parallel.dist.draw_rows``); None (the autoencoder
    draws) without one."""
    if not pdist.distributed():
        return None
    shape = (state.cfg.POSE2POSE.AUTOENCODER.CODE_DIM,)
    return pdist.draw_rows(lambda n: torch.randn((n, *shape), generator=state.rng,
                                                 device=state.device, dtype=state.ae.encoder.dtype),
                           batch_size)


def train_step(state: Pose2PoseTrainState, batch: Dict[str, object],
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One optimization step; returns ``(losses, results)`` as device tensors.
    ``noise`` (B, code_dim) replaces the reparameterization's draw. Under a
    process group the batch is the rank's shard: the losses are the global
    batch's, the gradients are averaged over ranks, and every rank writes
    every rank's rows into the banks."""
    cfg = state.cfg
    b = _to({k: batch[k] for k in ("poses", "clip_index", "speaker_stat")}, state.device)
    gt = b["poses"]
    if noise is None:
        noise = _global_noise(state, gt.shape[0])
    pred, mu, logvar = state.ae(gt, cfg.DATASET.NUM_FRAMES, noise=noise,
                                generator=state.rng)
    losses = pose2pose_losses(pred, gt, mu, logvar, cfg)
    state.opt.zero_grad(set_to_none=True)
    losses["loss"].backward()
    pdist.average_gradients(state.ae.parameters())
    state.opt.step()

    with torch.no_grad():
        mu, logvar = mu.detach(), logvar.detach()
        index = pdist.gather_rows(b["clip_index"])
        state.clip_code_mu[index] = pdist.gather_rows(mu.float())
        state.clip_code_logvar[index] = pdist.gather_rows(logvar.float())
        losses = {k: v.detach() for k, v in losses.items()}
        final = [_final(b, p, cfg) for p in (pred.detach(), gt)]
        losses.update(step_metrics(*final))
    state.step += 1
    return losses, {"poses_pred_batch": final[0], "poses_gt_batch": final[1],
                    "clip_code_mu": mu, "clip_code_logvar": logvar}


@torch.no_grad()
def eval_step(state: Pose2PoseTrainState, batch: Dict[str, object],
              external_code: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, sharded: bool = False
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The autoencoder in eval mode (BN running statistics) on a batch
    repeated TEST.MULTIPLE times; the reparameterization still samples, as in
    the JAX step. With ``external_code`` (B, code_dim) it only decodes that
    code, and computes no loss. ``sharded``: the batch is a rank's shard of
    a global eval batch, whose noise is drawn as ``train_step`` draws it."""
    cfg, multiple = state.cfg, state.cfg.TEST.MULTIPLE
    b = _to({k: batch[k] for k in ("poses", "speaker_stat") if k in batch}, state.device)
    if multiple > 1:
        b = multiply_batch(b, multiple)
    if external_code is not None:
        external_code = external_code.to(state.device)
    elif noise is None and sharded and "poses" in b:
        noise = _global_noise(state, b["poses"].shape[0])
    with eval_mode(state.ae):
        pred, mu, logvar = state.ae(b.get("poses"), cfg.DATASET.NUM_FRAMES,
                                    external_code, noise=noise, generator=state.rng)
    results = {"poses_pred_batch": _final(b, pred, cfg), "clip_code_mu": mu,
               "clip_code_logvar": logvar}
    losses: Dict[str, torch.Tensor] = {}
    if "poses" in b and external_code is None:
        losses = pose2pose_losses(pred, b["poses"], mu, logvar, cfg)
        results["poses_gt_batch"] = _final(b, b["poses"], cfg)
        losses.update(step_metrics(results["poses_pred_batch"], results["poses_gt_batch"],
                                   multiple))
    return losses, results


@torch.no_grad()
def demo_step(state: Pose2PoseTrainState, batch: Dict[str, object],
              interpolation_coeff: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Decode row ``int((DEMO.MULTIPLE - 1) * interpolation_coeff)`` of
    DEMO.CODE_PATH's ``"v"`` array, times 10, into (1, NUM_FRAMES, 2, K)
    pixel-space poses with the speaker statistics of the demo ``batch`` (its
    audio is not read); returns them with the code as ``clip_code_mu`` and
    zeros as ``clip_code_logvar``."""
    cfg = state.cfg
    if cfg.DEMO.CODE_PATH is None:
        raise ValueError("the Pose2Pose demo decodes the codes of DEMO.CODE_PATH (an npz "
                         "with a 'v' array): set it")
    idx = int((cfg.DEMO.MULTIPLE - 1) * (interpolation_coeff or 0))
    with np.load(cfg.DEMO.CODE_PATH) as z:
        code = np.asarray(z["v"][idx] * 10, np.float32)
    code = torch.from_numpy(code)[None].to(state.device)
    b = _to({"speaker_stat": batch["speaker_stat"]}, state.device)
    with eval_mode(state.ae):
        pred, mu, logvar = state.ae(None, cfg.DATASET.NUM_FRAMES, code, generator=state.rng)
    return {"poses_pred_batch": _final(b, pred, cfg), "clip_code_mu": mu,
            "clip_code_logvar": logvar}


def draw_figure_epoch(state: Pose2PoseTrainState) -> Dict[str, object]:
    """``{"clip_code": figure}`` of the ``clip_code_mu`` bank."""
    return {"clip_code": code_figure(state.clip_code_mu.float().cpu().numpy())}
