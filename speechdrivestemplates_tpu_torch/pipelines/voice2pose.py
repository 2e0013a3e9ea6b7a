"""The Voice2Pose train and eval steps: mel -> generator -> L1 + clip-code KL
[+ LSGAN].

Counterpart of the JAX package's ``Voice2Pose`` (``pipelines/voice2pose.py``):
a ``SequenceGeneratorCNN``, the frozen ``PoseSeqEncoder`` whose FGD features
are taken in eval, and whose train-mode BatchNorm statistics drift with every
train step, and for s2g-GAN the ``PoseSequenceDiscriminator`` with its own
Adam. The SDT configurations condition the generator on a template code from
a bank of per-clip codes: learned (SDT-BP, zero init, (N_train, 32), or
(N_train, 32, T) per frame with CLIP_CODE.FRAME_VARIANT) or a Pose2Pose
checkpoint's ``clip_code_mu``, frozen, with no optimizer (SDT-VAE,
CLIP_CODE.EXTERNAL_CODE). s2g's generator (CLIP_CODE.DIMENSION None) takes no
code and has no bank; it is BN-normalized and trains on global poses
(DATASET.HIERARCHICAL_POSE False). The frozen encoder starts from a seeded
init, or from a Pose2Pose checkpoint's encoder
(VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT).

One train step, in order (``train_step``):
  1. the generator's ``features`` of the batch's audio: the mel spectrogram
     for ``SequenceGeneratorCNN`` (the CUDA kernel on the card), each clip's
     normalized waveform for ``SequenceGeneratorHuBERT`` and
     ``SequenceGeneratorWavLM``; audio takes no gradient;
  2. the generator in train mode (an IN stem as plain cuDNN convs under
     autograd), with codes ``clips_code[clip_index]`` where it takes them;
  3. with a discriminator, three train-mode D forwards in the reference's
     order, each moving D's BN running statistics: the real poses, the
     prediction (for the G loss; D's parameters take no gradient from it),
     the detached prediction (for the D loss). D's input is ``disc_input``:
     POSE_DISCRIMINATOR.WHITE_LIST's keypoints, then frame differences with
     MOTION;
  4. L1 x LAMBDA_REG, plus the KL of the codes' batch statistics to N(0, 1)
     x LAMBDA_CLIP_KL (over the (B*T, dim) codes of a frame-variant bank),
     skipped while any code variance is exactly 0 (the first steps after the
     bank's zero init), plus MSE(D(fake), 1) x LAMBDA_GAN; the D loss
     (MSE(D(real), 1) + MSE(D(fake.detach()), 0)) x LAMBDA_GAN;
  5. one backward of their sum, then torch Adam steps, all from the pre-step
     weights: the generator with TRAIN.WD as L2 added to the gradient, a
     learned bank at LR x LR_SCALING with no decay (its gradient is dense, so
     rows not in the batch move by their moments), the discriminator at LR;
  6. the pose encoder in train mode under ``no_grad`` on the prediction, then
     on the ground truth (re-normalized by ``p2g_renorm`` on global poses):
     two BN statistics updates, no parameter update;
  7. L2 and lip-sync metrics on pixel-space poses.
Under a process group (``parallel/dist.py``) the batch is the rank's shard
of a global batch, and the step computes what JAX's sharded step computes:
every loss, the KL's code statistics, the metrics and every train-mode BN's
statistics are the global batch's (all-reduced, with gradient), each rank
backpropagates that same global loss, and the parameters' gradients are
averaged over ranks before the optimizers step; the ranks' weights stay
equal bit for bit. Without one, the step is the one-process step.
The learning rates follow MultiStepLR at epochs [N-10, N-2], gamma 0.1, when
TRAIN.LR_SCHEDULER is set (``make_scheduler``; ``end_epoch`` steps it).
A state built ``capturable`` (the trainer's choice for K train steps in one
CUDA graph, TRAIN.STEPS_PER_DISPATCH > 1) takes Adams with ``capturable=True``
and each learning rate in a device tensor, which the schedulers move in place.

One eval step (``eval_step``, the JAX ``_build_eval_step``): the mel, the
generator in eval mode (on the card an IN generator runs the mel kernel, then
the conv1 and stem kernels, as serving runs them) on the code
``condition_code`` picks, the losses (the GAN ones with D in eval mode), the
pose encoder in eval mode on the prediction and the ground truth (mu and
logvar: the FGD features), the metrics.

The demo (``demo_step``, the JAX ``demo_step``) takes one clip of any length
(a batch of the demo split) to pixel-space poses by one of three routes. With
DEMO.SEQUENCE_PARALLEL, ``seq_parallel_demo_forward``: the exact forward of
the whole clip with its time axis split over the ranks
(``parallel/seqparallel.py``). With
DEMO.WINDOWED and a clip longer than DEMO.WINDOW_FRAMES, ``windowed_demo_
forward``: the clip's windows (``ops/longform.py``) as one batch through the
eval forward at the window's shape, one code for all of them, the window poses
crossfaded back. Else the dense demo: one eval forward of the whole clip at
its own length, through the mel, conv1 and stem kernels on the card.
DEMO.LENGTH_BUCKET_S is read and ignored: the JAX package pads a clip to a
length bucket only to bound its compiles, and its trimmed output equals the
unpadded one to numerical precision; an eager forward compiles nothing.

The host-side artifacts (the JAX hooks of the same names): ``generate_video``
and ``generate_video_pair`` draw one clip's pixel-space poses at
SYS.VISUALIZATION_SCALING on SYS.CANVAS_SIZE (``utils/viz.py``), for
``utils/video.py``; ``draw_figure_epoch`` is the bank's 2-D PCA (``_pca_2d``,
numpy) as a scatter figure, ``train/clip_code`` at each epoch's end, where
the generator takes codes (a frame-variant bank's (N, dim, T) codes as N*T
rows).
"""

from __future__ import annotations

import contextlib
import functools
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models import build_model
from ..ops.longform import stitch_windows, window_audio
from ..ops.mel import _mel_filterbank_np
from ..ops.pose import (get_final_results, multiply_batch, step_metrics,
                        transform_normalized_parted2global)
from ..parallel import dist as pdist
from ..utils.device import resolve_device
from ..utils.viz import vis_relative_pose_clip, vis_relative_pose_pair_clip
from ..utils.weights import (check_bank_rows, external_code_bank, pose_encoder_from_ae_pth,
                             read_pth)
from .checkpoint import atomic_save

log = logging.getLogger(__name__)
ADAM = dict(betas=(0.9, 0.999), eps=1e-8)
# the batch keys the steps read, what the trainer stages on the card;
# speaker_stat_global exists on global poses only (DATASET.HIERARCHICAL_POSE False)
DEVICE_KEYS = ("audio", "poses", "clip_index", "speaker_stat", "speaker_stat_global")
_GROUP_FLAGS = ("capturable", "foreach", "fused", "differentiable")


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


def make_adam(params, lr: float, device: torch.device, capturable: bool,
              weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch Adam; ``capturable``: replayable in a CUDA graph, its bias
    correction computed on the device and its learning rate a float32 device
    tensor (a graph reads the tensor, so a scheduler must fill it in place)."""
    if capturable:
        return torch.optim.Adam(params, lr=torch.tensor(float(lr), device=device),
                                weight_decay=weight_decay, capturable=True, **ADAM)
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay, **ADAM)


def step_schedulers(schedulers, optimizers) -> None:
    """Step every scheduler. A learning rate held in a tensor stays that
    tensor: where a scheduler put a new object in its place, the value is
    copied into the old tensor, which goes back (a captured graph reads it)."""
    held = [(g, g["lr"]) for o in optimizers for g in o.param_groups
            if isinstance(g["lr"], torch.Tensor)]
    for s in schedulers:
        s.step()
    for g, t in held:
        if g["lr"] is not t:
            t.fill_(float(g["lr"]))
            g["lr"] = t


def load_optimizer(opt: torch.optim.Optimizer, saved: dict) -> None:
    """``opt.load_state_dict(saved)``, keeping what this run chose over what
    the saved run chose: its capturable/foreach flags, a learning rate held in
    a tensor (filled with the saved value in place) or as a float, and the
    step counts where its policy keeps them (on the parameter's device when
    capturable, else on the CPU)."""
    live = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
    opt.load_state_dict(saved)
    for g, was in zip(opt.param_groups, live):
        for k in _GROUP_FLAGS:
            if k in was:
                g[k] = was[k]
        for k in ("lr", "initial_lr"):
            if k not in g or k not in was:
                continue
            if isinstance(was[k], torch.Tensor):
                was[k].fill_(float(g[k]))
                g[k] = was[k]
            else:
                g[k] = float(g[k])
        on_device = g.get("capturable") or g.get("fused")
        for p in g["params"]:
            st = opt.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device if on_device else "cpu", torch.float32)


def mel_buffers() -> Dict[str, torch.Tensor]:
    """The reference models' ``mel_transfm`` buffers, as checkpoints carry them."""
    return {"mel_transfm.spectrogram.window":
                torch.from_numpy(np.hanning(401)[:400].astype(np.float32)),
            "mel_transfm.mel_scale.fb":
                torch.from_numpy(_mel_filterbank_np(16000, 512, 80, 55.0, 7500.0))}


def save_pth(path: str, state_dict: Dict[str, torch.Tensor], epoch: int, step: int) -> None:
    """The reference checkpoint layout: ``{epoch, step, model_state_dict}``
    with every key under ``module.``, written to a temporary name and renamed."""
    atomic_save({"epoch": int(epoch), "step": int(step),
                 "model_state_dict": {f"module.{k}": v.detach().cpu()
                                      for k, v in state_dict.items()}}, path)


@contextlib.contextmanager
def eval_mode(*modules):
    """Put ``modules`` (None skipped) in eval mode, and back as they were."""
    modules = [m for m in modules if m is not None]
    was = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, w in zip(modules, was):
            m.train(w)


class Voice2PoseTrainState:
    """The trained modules, their optimizers and schedulers, the template bank
    and the step count (the JAX package's ``Voice2Pose.state``). Weights come
    from a ``torch.Generator`` seeded with SYS.SEED (the generator's, then the
    discriminator's, then the pose encoder's), the eval codes' draws from
    another on the device. ``clips_code`` is None for a code-less generator
    (s2g), ``discriminator`` None without POSE_DISCRIMINATOR.NAME.
    ``num_train`` None (a test run) leaves the bank's rows to the checkpoint.
    ``capturable`` (default: on the card with TRAIN.STEPS_PER_DISPATCH > 1)
    builds the Adams for CUDA-graph replay. Weights and banks load into the
    existing tensors and a learning-rate tensor is filled in place, as a
    captured graph holds them by address; the trainer loads the optimizers'
    state before its first capture."""

    def __init__(self, cfg, num_train: Optional[int], device="cuda",
                 capturable: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_train = num_train
        gen = torch.Generator().manual_seed(cfg.SYS.SEED)
        v2p = cfg.VOICE2POSE
        cc = v2p.GENERATOR.CLIP_CODE
        self.generator = build_model(v2p.GENERATOR.NAME, cfg, self.device,
                                     generator=gen).train()
        self.external_code = cc.DIMENSION is not None and cc.EXTERNAL_CODE
        if cc.DIMENSION is None:
            self.clips_code = None
        elif self.external_code:
            path = cc.EXTERNAL_CODE_PTH or v2p.POSE_ENCODER.AE_CHECKPOINT
            if path is None:
                raise ValueError("CLIP_CODE.EXTERNAL_CODE needs a Pose2Pose checkpoint: "
                                 "CLIP_CODE.EXTERNAL_CODE_PTH or POSE_ENCODER.AE_CHECKPOINT")
            self.clips_code = external_code_bank(path, num_train).to(self.device)
        else:
            shape = (num_train or 1, cc.DIMENSION) + (
                (cfg.DATASET.NUM_FRAMES,) if cc.FRAME_VARIANT else ())
            self.clips_code = nn.Parameter(torch.zeros(shape, device=self.device))
        self.discriminator = None
        if v2p.POSE_DISCRIMINATOR.NAME is not None:
            self.discriminator = build_model(v2p.POSE_DISCRIMINATOR.NAME, cfg, self.device,
                                             generator=gen).train()
        self.pose_encoder = None
        if v2p.POSE_ENCODER.NAME is not None:
            self.pose_encoder = build_model(v2p.POSE_ENCODER.NAME, cfg, self.device,
                                            generator=gen)
            self.pose_encoder.train().requires_grad_(False)
            ae_ckpt = v2p.POSE_ENCODER.AE_CHECKPOINT
            if ae_ckpt is not None:
                self.pose_encoder.load_state_dict(
                    pose_encoder_from_ae_pth(ae_ckpt, self.pose_encoder.state_dict()),
                    strict=True)
        if capturable is None:
            capturable = self.device.type == "cuda" and cfg.TRAIN.STEPS_PER_DISPATCH > 1
        self.capturable = capturable
        self.opt_g = make_adam(self.generator.parameters(), cfg.TRAIN.LR, self.device,
                               capturable, cfg.TRAIN.WD)
        self.opt_code = None if self.clips_code is None or self.external_code else make_adam(
            [self.clips_code], cfg.TRAIN.LR * cc.LR_SCALING, self.device, capturable)
        self.opt_d = None if self.discriminator is None else make_adam(
            self.discriminator.parameters(), cfg.TRAIN.LR, self.device, capturable)
        self.schedulers = [s for s in (make_scheduler(o, cfg) for o in self.optimizers()) if s]
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.SYS.SEED)
        self.step = 0

    def _set_bank(self, bank: torch.Tensor) -> None:
        check_bank_rows(bank, self.num_train)
        bank = bank.float().to(self.device)
        if tuple(bank.shape) == tuple(self.clips_code.shape):
            with torch.no_grad():
                self.clips_code.copy_(bank)
        elif self.external_code:
            self.clips_code = bank.clone()
        elif self.num_train is None:  # a test run takes the checkpoint's rows
            self.clips_code = nn.Parameter(bank.clone())
        else:
            raise ValueError(f"clip-code bank {tuple(bank.shape)}: this configuration "
                             f"needs {tuple(self.clips_code.shape)}")

    def load(self, parts: Dict[str, object]) -> None:
        """Load ``{"generator", "clips_code", "pose_encoder"[, "discriminator"]}``
        (the form of ``utils.weights.state_from_jax``), strictly: a bank where
        the generator takes codes and None where it does not, and the
        discriminator's weights where this configuration has one."""
        self.generator.load_state_dict(parts["generator"], strict=True)
        if (parts["clips_code"] is None) != (self.clips_code is None):
            raise ValueError("the clip-code bank does not fit the generator: "
                             "CLIP_CODE.DIMENSION is "
                             f"{self.cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION}")
        if self.clips_code is not None:
            self._set_bank(parts["clips_code"])
        if self.discriminator is not None:
            self.discriminator.load_state_dict(parts["discriminator"], strict=True)
        if self.pose_encoder is not None:
            self.pose_encoder.load_state_dict(parts["pose_encoder"], strict=True)

    def load_pth(self, path: str) -> None:
        """Weights from a reference-layout Voice2Pose checkpoint, as the JAX
        package's ``load_torch_pth`` takes them: the generator; the bank and
        the discriminator (``netD_pose.*``) where this configuration has them;
        the pose encoder where the checkpoint has one; each strictly. Its
        ``pose_encoder.*``, running statistics drifted by training included,
        win over an AE_CHECKPOINT's encoder: they are what the reference's test
        run evaluates FGD with."""
        sd = read_pth(path)

        def under(prefix):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

        self.generator.load_state_dict(under("netG."), strict=True)
        if "clips_code" in sd and self.clips_code is not None:
            self._set_bank(sd["clips_code"])
        for module, part in ((self.discriminator, under("netD_pose.")),
                             (self.pose_encoder, under("pose_encoder."))):
            if module is not None and part:
                module.load_state_dict(part, strict=True)

    def optimizers(self) -> list:
        """The generator's, the bank's and the discriminator's Adams, those the
        configuration has, in that order: D last, so that the resume files of
        the code-bank configurations keep their order."""
        return [o for o in (self.opt_g, self.opt_code, self.opt_d) if o is not None]

    def end_epoch(self) -> None:
        step_schedulers(self.schedulers, self.optimizers())

    def learning_rates(self) -> Dict[str, float]:
        """The JAX ``current_lrs`` names: G, ClipCode, D_pose."""
        lrs = {"G": self.opt_g, "ClipCode": self.opt_code, "D_pose": self.opt_d}
        return {k: float(o.param_groups[0]["lr"]) for k, o in lrs.items() if o is not None}

    def train_state_dict(self) -> Dict[str, object]:
        return train_state_dict(self)

    def load_train_state(self, sd: Dict[str, object]) -> None:
        load_train_state(self, sd)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The reference ``Voice2PoseModel`` keys (without ``module.``), as the
        JAX ``export_voice2pose`` writes them: the mel buffers, ``netG.*``,
        ``clips_code`` where there is a bank, ``netD_pose.*`` where there is a
        discriminator, ``pose_encoder.*``."""
        sd = mel_buffers()
        sd.update({f"netG.{k}": v for k, v in self.generator.state_dict().items()})
        if self.clips_code is not None:
            sd["clips_code"] = self.clips_code.detach()
        for prefix, module in (("netD_pose.", self.discriminator),
                               ("pose_encoder.", self.pose_encoder)):
            if module is not None:
                sd.update({prefix + k: v for k, v in module.state_dict().items()})
        return sd

    def save_checkpoint(self, path: str, epoch: int, step: int) -> None:
        save_pth(path, self.state_dict(), epoch, step)


def train_state_dict(state) -> Dict[str, object]:
    """What a resume needs beyond the weights: the optimizers' and schedulers'
    ``state_dict()``s, the step count and the noise generator's state."""
    return {"optimizers": [o.state_dict() for o in state.optimizers()],
            "schedulers": [s.state_dict() for s in state.schedulers],
            "step": int(state.step), "rng": state.rng.get_state()}


def load_train_state(state, sd: Dict[str, object]) -> None:
    """Load ``train_state_dict``'s output into ``state`` (``load_optimizer``
    for each optimizer)."""
    opts = state.optimizers()
    if len(sd["optimizers"]) != len(opts) or len(sd["schedulers"]) != len(state.schedulers):
        raise ValueError(f"the resume state holds {len(sd['optimizers'])} optimizers and "
                         f"{len(sd['schedulers'])} schedulers; this configuration has "
                         f"{len(opts)} and {len(state.schedulers)}")
    for o, saved in zip(opts, sd["optimizers"]):
        load_optimizer(o, saved)
    for s, saved in zip(state.schedulers, sd["schedulers"]):
        s.load_state_dict(saved)
    state.step = int(sd["step"])
    state.rng.set_state(sd["rng"])


def _mse(x: torch.Tensor, target: float) -> torch.Tensor:
    return pdist.mean_over_ranks(((x - target) ** 2).mean())


def generator_losses(pred: torch.Tensor, gt: torch.Tensor, code: Optional[torch.Tensor],
                     cfg, score_fake: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(G_loss, {"G_reg_loss"[, "G_clipcode_kl_loss"][, "G_pose_gan_loss"],
    "G_loss"})`` for a prediction and its target: the KL for the batch's (B,
    code_dim) codes, or (B, code_dim, T) per-frame codes, whose KL is over the
    (B*T, code_dim) rows (None for a code-less generator: no KL); the LSGAN
    term for the discriminator's scores of the prediction, ``score_fake``.
    Under a process group every term is the global batch's, as JAX's sharded
    step takes it: the L1 and MSE means are the mean over ranks, the KL's
    ``mu`` and unbiased ``var`` are over every rank's rows
    (``parallel.dist``); each rank then holds the same loss, and its
    gradient flows back through the all-reduces."""
    gcfg = cfg.VOICE2POSE.GENERATOR
    reg = pdist.mean_over_ranks((pred - gt).abs().mean()) * gcfg.LAMBDA_REG
    losses = {"G_reg_loss": reg}
    g_loss = reg
    if code is not None:
        if code.ndim == 3:
            code = code.transpose(1, 2).reshape(-1, code.shape[1])
        if pdist.distributed():
            var, mu, _ = pdist.batch_var_mean(code, (0,), correction=1)
        else:
            mu, var = code.mean(0), code.var(0, correction=1)
        safe = torch.where(var > 0, var, torch.ones_like(var))
        kl = 0.5 * (-torch.log(safe) + mu ** 2 + var - 1.0).mean() * gcfg.LAMBDA_CLIP_KL
        kl = torch.where((var != 0).all(), kl, torch.zeros_like(kl))
        losses["G_clipcode_kl_loss"] = kl
        g_loss = g_loss + kl
    if score_fake is not None:
        gan = _mse(score_fake, 1.0) * cfg.VOICE2POSE.POSE_DISCRIMINATOR.LAMBDA_GAN
        losses["G_pose_gan_loss"] = gan
        g_loss = g_loss + gan
    losses["G_loss"] = g_loss
    return g_loss, losses


def disc_losses(score_real: torch.Tensor, score_fake: torch.Tensor,
                cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The LSGAN discriminator loss (MSE(real, 1) + MSE(fake, 0)) x LAMBDA_GAN
    and the mean scores (the JAX ``_disc_losses``)."""
    d_loss = ((_mse(score_real, 1.0) + _mse(score_fake, 0.0))
              * cfg.VOICE2POSE.POSE_DISCRIMINATOR.LAMBDA_GAN)
    return d_loss, {"D_pose_gan_loss": d_loss,
                    "pose_score_fake": pdist.mean_over_ranks(score_fake.mean()),
                    "pose_score_real": pdist.mean_over_ranks(score_real.mean())}


@functools.lru_cache(maxsize=8)
def _white_list(keypoints: tuple, device: torch.device) -> torch.Tensor:
    # cached: the first (eager) step makes it, before a CUDA graph could copy
    # it; outside inference mode, so that autograd may use it later
    with torch.inference_mode(False):
        return torch.tensor(keypoints, dtype=torch.long, device=device)


def disc_input(poses: torch.Tensor, cfg) -> torch.Tensor:
    """The discriminator's view of (B, T, 2, K) poses: POSE_DISCRIMINATOR.
    WHITE_LIST's keypoints, then, with MOTION, the T - 1 frame-to-frame
    differences (the JAX ``_disc_input``)."""
    dcfg = cfg.VOICE2POSE.POSE_DISCRIMINATOR
    if dcfg.WHITE_LIST is not None:
        poses = poses.index_select(-1, _white_list(tuple(dcfg.WHITE_LIST), poses.device))
    if dcfg.MOTION:
        poses = poses[:, 1:] - poses[:, :-1]
    return poses


def p2g_renorm(batch: Dict[str, object], poses: torch.Tensor, cfg) -> torch.Tensor:
    """The FGD encoder's input on global poses (the JAX ``_p2g_renorm``, as
    written there): denormalized with ``speaker_stat`` (the global statistics
    on global poses), re-rooted by ``parted_to_global``, renormalized with
    ``speaker_stat_global``."""
    stat, statg = batch["speaker_stat"], batch["speaker_stat_global"]
    return transform_normalized_parted2global(poses, stat["mean"], stat["std"], statg["mean"],
                                              statg["std"], cfg.DATASET.NUM_LANDMARKS)


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module``'s parameters take no gradient inside (its forward still
    moves its BN statistics); they are put back as they were."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _to_device(batch: Dict[str, object], dev: torch.device) -> Dict[str, object]:
    """The batch's DEVICE_KEYS on ``dev`` (``speaker_stat``s nested)."""
    return {k: ({kk: vv.to(dev, non_blocking=True) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(dev, non_blocking=True))
            for k, v in batch.items() if k in DEVICE_KEYS}


def _encoder_inputs(b, pred: torch.Tensor, gt: torch.Tensor, cfg):
    if cfg.DATASET.HIERARCHICAL_POSE:
        return pred, gt
    return p2g_renorm(b, pred, cfg), p2g_renorm(b, gt, cfg)


def train_step(state: Voice2PoseTrainState, batch: Dict[str, object],
               plain: bool = False) -> Tuple[Dict[str, torch.Tensor], Dict[str, object]]:
    """One optimization step on a batch of ``datasets.gesture_dataset``;
    returns ``(losses, results)`` as device tensors (no host sync). ``plain``
    takes the mel's plain version even on the card (a reference)."""
    cfg = state.cfg
    b = _to_device(batch, state.device)
    gt, stat = b["poses"], b["speaker_stat"]

    feats = state.generator.features(b["audio"], plain)
    code = None if state.clips_code is None else state.clips_code[b["clip_index"]]
    pred = state.generator(feats, cfg.DATASET.NUM_FRAMES, code)
    D, score_fake = state.discriminator, None
    if D is not None:
        # the reference's three train-mode forwards, in its order: each moves
        # D's BN statistics once; D steps from its pre-step weights
        fake = disc_input(pred, cfg)
        score_real = D(disc_input(gt, cfg))
        with frozen(D):
            score_fake = D(fake)
        d_loss, d_losses = disc_losses(score_real, D(fake.detach()), cfg)
    g_loss, losses = generator_losses(pred, gt, code, cfg, score_fake)
    total = g_loss
    if D is not None:
        losses.update(d_losses)
        total = g_loss + d_loss  # G's gradient from g_loss only, D's from d_loss only
    optimizers = state.optimizers()
    for o in optimizers:
        o.zero_grad(set_to_none=True)
    total.backward()
    # every rank backpropagated the same global loss: the mean of the ranks'
    # gradients is its gradient (parallel/dist.py)
    pdist.average_gradients([p for o in optimizers for g in o.param_groups for p in g["params"]])
    for o in optimizers:
        o.step()

    losses = {k: v.detach() for k, v in losses.items()}
    results: Dict[str, object] = {}
    with torch.no_grad():
        pred = pred.detach()
        if state.pose_encoder is not None:
            enc_pred, enc_gt = _encoder_inputs(b, pred, gt, cfg)
            mu_p, lv_p = state.pose_encoder(enc_pred)
            mu_g, lv_g = state.pose_encoder(enc_gt)
            results.update(mu_pred=mu_p, logvar_pred=lv_p, mu_gt=mu_g, logvar_gt=lv_g)
        final = [get_final_results(p, stat["mean"], stat["std"], stat["scale_factor"],
                                   cfg.DATASET.HIERARCHICAL_POSE, cfg.DATASET.NUM_LANDMARKS)
                 for p in (pred, gt)]
        losses.update(step_metrics(*final))
    results.update(poses_pred_batch=final[0], poses_gt_batch=final[1])
    state.step += 1
    return losses, results


def condition_code(state: Voice2PoseTrainState, batch: Dict[str, torch.Tensor],
                   interpolation_coeff: Optional[float] = None,
                   sharded: bool = False, plain: bool = False) -> Optional[torch.Tensor]:
    """The eval template codes of a device batch (the eval modes of the JAX
    ``_condition_code``; a train step takes the bank rows at ``clip_index``);
    None for a code-less generator. The first mode set of:
    CLIP_CODE.SAMPLE_FROM_NORMAL (N(0, 1) codes), CLIP_CODE.TEST_WITH_GT_CODE
    (the eval-mode pose encoder's mu of the ground truth, re-normalized on
    global poses), DEMO.CODE_INDEX (that bank row for every sample, moved
    towards DEMO.CODE_INDEX_B, where it is set, by ``interpolation_coeff``);
    else a bank row drawn uniformly for each sample. Draws come from
    ``state.rng``; for a ``sharded`` batch (a rank's shard of the global
    batch) they are drawn for the global batch on every rank, and each takes
    its rows (``parallel.dist.draw_rows``), so the ranks' generators stay in
    step and the codes are those of a one-process run. ``plain`` runs the pose
    encoder's plain layers even on the card (a reference)."""
    if state.clips_code is None:
        return None
    cfg, bank = state.cfg, state.clips_code.detach()
    cc = cfg.VOICE2POSE.GENERATOR.CLIP_CODE
    B = batch["audio"].shape[0]
    rows = pdist.draw_rows if sharded else (lambda draw, n: draw(n))
    if cc.SAMPLE_FROM_NORMAL:
        return rows(lambda n: torch.randn(n, cc.DIMENSION, generator=state.rng,
                                          device=state.device), B)
    if cc.TEST_WITH_GT_CODE:
        if state.pose_encoder is None:
            raise ValueError("CLIP_CODE.TEST_WITH_GT_CODE needs VOICE2POSE.POSE_ENCODER")
        gt = batch["poses"]
        if not cfg.DATASET.HIERARCHICAL_POSE:
            gt = p2g_renorm(batch, gt, cfg)
        with eval_mode(state.pose_encoder):
            return state.pose_encoder(gt, plain)[0].float()
    if cfg.DEMO.CODE_INDEX is not None:
        return demo_code(state, interpolation_coeff)[None].expand(B, *bank.shape[1:])
    idx = rows(lambda n: torch.randint(0, bank.shape[0], (n,), generator=state.rng,
                                       device=state.device), B)
    return bank[idx]


@torch.no_grad()
def eval_step(state: Voice2PoseTrainState, batch: Dict[str, object],
              fixed_code: Optional[torch.Tensor] = None, plain: bool = False,
              num_frames: Optional[int] = None,
              interpolation_coeff: Optional[float] = None, sharded: bool = False
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One eval step; returns ``(losses, results)`` as device tensors: the
    losses (the GAN ones with D in eval mode) and metrics where the batch has
    ground truth, which it repeats TEST.MULTIPLE times (a demo batch has
    none), the pixel-space poses, the codes where the generator takes them,
    and the pose encoder's mu and logvar of prediction and ground truth.
    ``fixed_code`` replaces ``condition_code``'s, which takes
    ``interpolation_coeff``; ``plain`` takes the plain mel, stem and BN
    layers even on the card (a reference). ``num_frames`` (default DATASET.NUM_FRAMES) is the
    output's length. ``sharded``: the batch is this rank's shard of a global
    eval batch (``condition_code``); the losses and metrics are the global
    batch's under a process group in any case."""
    cfg, dev = state.cfg, state.device
    b = _to_device(batch, dev)
    if cfg.TEST.MULTIPLE > 1 and "poses" in b:
        b = multiply_batch(b, cfg.TEST.MULTIPLE)
    stat = b["speaker_stat"]
    num_frames = num_frames or cfg.DATASET.NUM_FRAMES

    def final(p):
        return get_final_results(p, stat["mean"], stat["std"], stat["scale_factor"],
                                 cfg.DATASET.HIERARCHICAL_POSE, cfg.DATASET.NUM_LANDMARKS)

    D = state.discriminator
    with eval_mode(state.generator, state.pose_encoder, D):
        feats = state.generator.features(b["audio"], plain)
        code = (fixed_code.to(dev) if fixed_code is not None
                else condition_code(state, b, interpolation_coeff, sharded, plain))
        pred = state.generator(feats, num_frames, code, plain=plain)
        results = {"poses_pred_batch": final(pred)}
        if code is not None:
            results["condition_code"] = code
        losses: Dict[str, torch.Tensor] = {}
        if "poses" in b:
            gt = b["poses"]
            score_fake = None if D is None else D(disc_input(pred, cfg), plain)
            _, losses = generator_losses(pred, gt, code, cfg, score_fake)
            if D is not None:
                losses.update(disc_losses(D(disc_input(gt, cfg), plain), score_fake, cfg)[1])
            if state.pose_encoder is not None:
                enc_pred, enc_gt = _encoder_inputs(b, pred, gt, cfg)
                mu_p, lv_p = state.pose_encoder(enc_pred, plain)
                mu_g, lv_g = state.pose_encoder(enc_gt, plain)
                results.update(mu_pred=mu_p, logvar_pred=lv_p, mu_gt=mu_g, logvar_gt=lv_g)
            results["poses_gt_batch"] = final(gt)
            losses.update(step_metrics(results["poses_pred_batch"], results["poses_gt_batch"]))
    return losses, results


# ---- the demo ---------------------------------------------------------------------

def demo_code(state: Voice2PoseTrainState,
              interpolation_coeff: Optional[float] = None) -> Optional[torch.Tensor]:
    """The one code of a whole clip (its windows share it): bank row
    DEMO.CODE_INDEX, moved towards DEMO.CODE_INDEX_B by
    ``interpolation_coeff``, or a row drawn from ``state.rng``; None for a
    code-less generator."""
    if state.clips_code is None:
        return None
    d, bank = state.cfg.DEMO, state.clips_code.detach()
    if d.CODE_INDEX is None:
        return bank[torch.randint(0, bank.shape[0], (), generator=state.rng,
                                  device=state.device)]
    code = bank[d.CODE_INDEX]
    if interpolation_coeff is not None and d.CODE_INDEX_B is not None:
        code = code * (1 - interpolation_coeff) + bank[d.CODE_INDEX_B] * interpolation_coeff
    return code


def windowed_demo_forward(state: Voice2PoseTrainState, batch: Dict[str, object],
                          num_frames: int, interpolation_coeff: Optional[float] = None,
                          plain: bool = False) -> Dict[str, torch.Tensor]:
    """The clip's DEMO.WINDOW_FRAMES windows, overlapping by two
    DEMO.HALO_FRAMES, as one batch through the eval forward at the window's
    shape, then crossfaded back into ``num_frames`` frames."""
    d = state.cfg.DEMO
    windows, plan = window_audio(np.asarray(batch["audio"][0]), num_frames, d.WINDOW_FRAMES,
                                 d.HALO_FRAMES)
    n = len(windows)
    wbatch = {"audio": torch.from_numpy(windows),
              "speaker_stat": {k: torch.as_tensor(v)[:1].expand(n, *v.shape[1:])
                               for k, v in batch["speaker_stat"].items()}}
    code = demo_code(state, interpolation_coeff)
    fixed = None if code is None else code[None].expand(n, *code.shape)
    _, res = eval_step(state, wbatch, fixed, plain, num_frames=d.WINDOW_FRAMES)
    pred = res["poses_pred_batch"].float().cpu().numpy()
    out = {"poses_pred_batch": torch.from_numpy(
        stitch_windows(pred, plan, num_frames, d.HALO_FRAMES)[None])}
    if fixed is not None:
        out["condition_code"] = fixed[:1]
    return out


def seq_parallel_demo_forward(state: Voice2PoseTrainState, batch: Dict[str, object],
                              num_frames: int, interpolation_coeff: Optional[float] = None,
                              plain: bool = False) -> Dict[str, torch.Tensor]:
    """The exact long-form demo (the JAX ``_seq_parallel_demo_forward``): one
    generator forward with the time axis split over the ranks
    (``parallel/seqparallel.py``) on the clip's audio zero-padded to 8 x
    ranks mel columns, at ``num_frames`` padded to 32 x ranks frames, the pad
    frames then trimmed. Every rank computes the whole padded clip's mel
    (the mel kernel on the card) and ends with every frame. Raises
    ValueError where the clip is too short for the ranks."""
    from ..parallel.seqparallel import generator_seq_parallel

    cfg, dev = state.cfg, state.device
    if not state.generator.MEL_INPUT:
        raise ValueError(f"{type(state.generator).__name__}: the time axis splits over the "
                         "ranks in a mel encoder only")
    if state.clips_code is not None and cfg.VOICE2POSE.GENERATOR.CLIP_CODE.FRAME_VARIANT:
        raise NotImplementedError(
            "DEMO.SEQUENCE_PARALLEL does not support FRAME_VARIANT clip "
            "codes (the per-frame code bank is train-length-shaped; "
            "use DEMO.WINDOWED)")
    n = pdist.world_size()
    t_pad = -(-num_frames // (32 * n)) * (32 * n)
    audio = np.asarray(batch["audio"][0], np.float32)
    t_mel = -(-(len(audio) // 160 + 2) // (8 * n)) * (8 * n)
    audio_pad = np.zeros(((t_mel - 1) * 160,), np.float32)
    audio_pad[: len(audio)] = audio
    with eval_mode(state.generator):
        mel = state.generator.features(torch.from_numpy(audio_pad[None]).to(dev), plain)
        code = demo_code(state, interpolation_coeff)
        code = None if code is None else code[None]
        pred = generator_seq_parallel(state.generator, mel, t_pad, code)[:, :num_frames]
    stat = _to_device({"speaker_stat": batch["speaker_stat"]}, dev)["speaker_stat"]
    out = {"poses_pred_batch": get_final_results(
        pred, stat["mean"], stat["std"], stat["scale_factor"], cfg.DATASET.HIERARCHICAL_POSE,
        cfg.DATASET.NUM_LANDMARKS)}
    if code is not None:
        out["condition_code"] = code
    return out


def demo_step(state: Voice2PoseTrainState, batch: Dict[str, object],
              interpolation_coeff: Optional[float] = None,
              plain: bool = False) -> Dict[str, torch.Tensor]:
    """A demo batch (one clip) -> ``{"poses_pred_batch": (1, T, 2, K)
    [, "condition_code"]}``: with DEMO.SEQUENCE_PARALLEL the exact
    sequence-parallel forward over the ranks (where the clip is too short
    for them, JAX's warning and the dense forward); else windowed with
    DEMO.WINDOWED where the clip is longer than a window, else one eval
    forward of the whole clip at its own length."""
    num_frames = int(np.asarray(batch["num_frames"]).reshape(-1)[0])
    d = state.cfg.DEMO
    if d.SEQUENCE_PARALLEL:
        try:
            return seq_parallel_demo_forward(state, batch, num_frames, interpolation_coeff,
                                             plain)
        except ValueError as e:
            # a clip too short for the ranks' halos: the dense forward takes any clip
            log.warning("DEMO.SEQUENCE_PARALLEL unavailable for this clip (%s); using the "
                        "dense forward", e)
    elif d.WINDOWED and num_frames > d.WINDOW_FRAMES:
        return windowed_demo_forward(state, batch, num_frames, interpolation_coeff, plain)
    return eval_step(state, batch, plain=plain, num_frames=num_frames,
                     interpolation_coeff=interpolation_coeff)[1]


# ---- host-side artifacts: videos and the epoch figure ------------------------------

def generate_video(cfg, poses: np.ndarray) -> np.ndarray:
    """(T, 2, K) pixel-space poses -> (T, H, W, 3) BGR frames."""
    return vis_relative_pose_clip(poses * cfg.SYS.VISUALIZATION_SCALING, cfg.SYS.CANVAS_SIZE)


def generate_video_pair(cfg, pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Two (T, 2, K) clips side by side -> (T, H, W, 3) BGR frames."""
    s = cfg.SYS.VISUALIZATION_SCALING
    return vis_relative_pose_pair_clip(pred * s, gt * s, cfg.SYS.CANVAS_SIZE)


def _pca_2d(x: np.ndarray) -> np.ndarray:
    """The rows of ``x`` on their first two principal axes (SVD of the
    centred rows)."""
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def code_figure(code: np.ndarray):
    """The scatter of ``code``'s rows on their first two principal axes, a
    matplotlib figure on an Agg canvas (pyplot's global state untouched)."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure()
    FigureCanvasAgg(fig)
    xy = _pca_2d(code)
    fig.add_subplot().scatter(xy[:, 0], xy[:, 1], alpha=0.2, edgecolors="none", s=1)
    fig.tight_layout()
    return fig


def draw_figure_epoch(state: Voice2PoseTrainState) -> Dict[str, object]:
    """``{"clip_code": figure}`` of the bank, or ``{}`` for a code-less generator."""
    if state.clips_code is None:
        return {}
    code = state.clips_code.detach().float().cpu().numpy()
    if code.ndim == 3:
        code = code.transpose(0, 2, 1).reshape(-1, code.shape[1])
    return {"clip_code": code_figure(code)}
