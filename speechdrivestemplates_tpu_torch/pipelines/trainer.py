"""The training loop, validation and the test run, for both pipelines.

Counterpart of the JAX package's ``Trainer`` (``pipelines/trainer.py``),
single process; ``PIPELINE_TYPE`` picks Voice2Pose or Pose2Pose. A run writes
into ``<SYS.OUTPUT_DIR>/<datetime>_<tag>/``: the log ``<tag>.log``; in
training, every TRAIN.CHECKPOINT_INTERVAL epochs,
``checkpoints/checkpoint_epoch-E_step-S.pth`` in the reference layout, then,
with TRAIN.VALIDATE, a pass over the val split; with TRAIN.SAVE_NPZ /
TEST.SAVE_NPZ, ``results/epoch{E}-{TAG}-step{S}.npz`` archives of a few
steps' results. An evaluation (``validate``, ``test``) weights each batch's
losses by its true sample count, so the ragged last batch counts as what it
holds, and adds the FGD of the pose encoder's latents (Voice2Pose).
Resume is not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import datetime
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..datasets.gesture_dataset import EpochBatches, GestureDataset, collate
from ..ops.fgd import compute_fgd
from ..utils.device import resolve_device
from . import pose2pose, voice2pose

log = logging.getLogger(__name__)

PIPELINES = {
    "Voice2Pose": SimpleNamespace(state=voice2pose.Voice2PoseTrainState,
                                  train_step=voice2pose.train_step,
                                  eval_step=voice2pose.eval_step),
    "Pose2Pose": SimpleNamespace(state=pose2pose.Pose2PoseTrainState,
                                 train_step=pose2pose.train_step,
                                 eval_step=pose2pose.eval_step),
}
FGD_KEYS = ("mu_pred", "logvar_pred", "mu_gt", "logvar_gt")


def pipeline(cfg) -> SimpleNamespace:
    if cfg.PIPELINE_TYPE not in PIPELINES:
        raise ValueError(f"PIPELINE_TYPE {cfg.PIPELINE_TYPE!r}: the port has "
                         f"{sorted(PIPELINES)}")
    return PIPELINES[cfg.PIPELINE_TYPE]


def check_trainer_options(cfg, evaluates: bool) -> None:
    """Raise for what the port lacks: NotImplementedError for the options not
    ported yet (TEST.SAVE_VIDEO only where the run evaluates), ValueError for
    an unknown pipeline."""
    p = pipeline(cfg)
    todo = {"TRAIN.SAVE_VIDEO": (cfg.TRAIN.SAVE_VIDEO, "pose videos", 13),
            "TEST.SAVE_VIDEO": (evaluates and cfg.TEST.SAVE_VIDEO, "pose videos", 13)}
    for key, (on, what, item) in todo.items():
        if on:
            raise NotImplementedError(f"{key} True ({what}) is not ported yet: ROADMAP.md "
                                      f"queue A, item {item}; pass {key} False")
    if p is PIPELINES["Voice2Pose"]:
        voice2pose.check_supported(cfg)


def train_loader(cfg) -> torch.utils.data.DataLoader:
    """The train split in the JAX loader's batches (``loader.batch_sampler
    .set_epoch`` picks the epoch's shuffle), read by SYS.NUM_WORKERS worker
    processes that live as long as the loader."""
    dataset = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg)
    if len(dataset) < cfg.TRAIN.BATCH_SIZE:
        raise ValueError(f"{len(dataset)} train clips make no full batch of "
                         f"TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE}")
    workers = cfg.SYS.NUM_WORKERS
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=EpochBatches(len(dataset), cfg.TRAIN.BATCH_SIZE, cfg.SYS.SEED),
        collate_fn=collate, num_workers=workers, persistent_workers=workers > 0)


def eval_loader(cfg) -> torch.utils.data.DataLoader:
    """The val split in order, TEST.BATCH_SIZE a batch, the ragged last batch
    kept (the JAX eval loader: no shuffle, no drop)."""
    dataset = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg, split="val")
    if not len(dataset):
        raise ValueError(f"no val ('dev') clips for speaker {cfg.DATASET.SPEAKER!r} under "
                         f"{cfg.DATASET.ROOT_DIR}")
    return torch.utils.data.DataLoader(
        dataset, batch_size=cfg.TEST.BATCH_SIZE, shuffle=False, drop_last=False,
        collate_fn=collate, num_workers=cfg.SYS.NUM_WORKERS)


def save_results(base_path: str, tag: str, step: int, epoch: int,
                 results: Dict[str, torch.Tensor]) -> str:
    """``results/epoch{E}-{TAG}-step{S}.npz`` under the run's directory."""
    res_dir = os.path.join(base_path, "results")
    os.makedirs(res_dir, exist_ok=True)
    path = os.path.join(res_dir, f"epoch{epoch}-{tag}-step{step}.npz")
    np.savez(path, **{k: v.detach().float().cpu().numpy() for k, v in results.items()})
    return path


def _line(values: Dict[str, object]) -> str:
    return "".join(f"{k}: {float(v):.5f}  " for k, v in values.items())


def train_epoch(state, loader: torch.utils.data.DataLoader, epoch: int,
                global_step: int = 0, base_path: Optional[str] = None
                ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """One epoch (``epoch`` counts from 1): every batch through the pipeline's
    train step, a log line every SYS.LOG_INTERVAL steps, TRAIN.NUM_RESULT_SAMPLE
    result archives with TRAIN.SAVE_NPZ (into ``base_path``), then the
    schedulers' step. Returns the steps taken and the last step's losses."""
    cfg = state.cfg
    step_fn = pipeline(cfg).train_step
    loader.batch_sampler.set_epoch(epoch)
    n, tic = len(loader), time.perf_counter()
    every = max(1, n // cfg.TRAIN.NUM_RESULT_SAMPLE)
    losses: Dict[str, torch.Tensor] = {}
    for t, batch in enumerate(loader, 1):
        losses, results = step_fn(state, batch)
        if t % cfg.SYS.LOG_INTERVAL == 0:
            per_step = (time.perf_counter() - tic) / cfg.SYS.LOG_INTERVAL
            tic = time.perf_counter()
            msg = (f"[TRAIN] epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  step: {t}/{n}  "
                   f"global_step: {global_step + t}  time: {per_step:.3f}  ")
            msg += "".join(f"lr_{k}: {lr:.1e}  " for k, lr in state.learning_rates().items())
            log.info(msg + _line(losses))
        if cfg.TRAIN.SAVE_NPZ and base_path is not None and t % every == 0:
            save_results(base_path, "TRAIN", t, epoch, results)
    state.end_epoch()
    return n, losses


def evaluate(state, loader: torch.utils.data.DataLoader, epoch: int = 0,
             base_path: Optional[str] = None) -> Dict[str, float]:
    """One pass of the pipeline's eval step over ``loader`` (epoch 0: a test
    run, tagged TEST; else a validation, VAL). Returns the epoch's losses and
    metrics, each batch weighted by its true sample count, and FGD_mu and
    FGD_mu_logvar when the pipeline gives pose-encoder latents."""
    cfg = state.cfg
    tag = "TEST" if epoch == 0 else "VAL"
    eval_fn = pipeline(cfg).eval_step
    n_batches = len(loader)
    every = max(1, n_batches // cfg.TEST.NUM_RESULT_SAMPLE)
    sums: Dict[str, torch.Tensor] = {}
    latents: Dict[str, list] = {k: [] for k in FGD_KEYS}
    num, tic = 0, time.perf_counter()
    for t, batch in enumerate(loader, 1):
        true_bs = batch["poses"].shape[0]
        losses, results = eval_fn(state, batch)
        for k, v in losses.items():
            sums[k] = sums[k] + v.double() * true_bs if k in sums else v.double() * true_bs
        for k in FGD_KEYS:
            if k in results:
                latents[k].append(results[k].float().cpu().numpy())
        num += true_bs
        if t % cfg.SYS.LOG_INTERVAL == 0:
            log.info(f"[{tag}] epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  step: {t}/{n_batches}  "
                     + _line(losses))
        if cfg.TEST.SAVE_NPZ and base_path is not None and t % every == 0:
            save_results(base_path, tag, t, epoch, results)
    metrics = {k: float(v) / num for k, v in sums.items()}
    if all(latents[k] for k in FGD_KEYS):
        lat = {k: np.concatenate(v) for k, v in latents.items()}
        metrics["FGD_mu"] = compute_fgd(lat["mu_pred"], lat["mu_gt"])
        metrics["FGD_mu_logvar"] = compute_fgd(
            np.concatenate([lat["mu_pred"], lat["logvar_pred"]], 1),
            np.concatenate([lat["mu_gt"], lat["logvar_gt"]], 1))
    counter = f"epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  " if tag == "VAL" else ""
    log.info(f"[{tag}] {counter}val_time: {(time.perf_counter() - tic) / 60:.1f} min  "
             f"num_samples: {num}  " + _line(metrics))
    return metrics


class _RunDir:
    """``<SYS.OUTPUT_DIR>/<datetime>_<tag>/`` and its log file, attached to this
    module's logger while the run lasts."""

    def __init__(self, cfg, tag: str, subdirs=()):
        stamp = str(datetime.now()).replace(".", "-").replace(":", "-").replace(" ", "_")
        self.path = os.path.join(cfg.SYS.OUTPUT_DIR, f"{stamp}_{tag}")
        os.makedirs(self.path)
        for d in subdirs:
            os.makedirs(os.path.join(self.path, d))
        self.handler = logging.FileHandler(os.path.join(self.path, f"{tag}.log"))
        self.handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)-0.5s] %(message)s"))

    def __enter__(self):
        log.addHandler(self.handler)
        log.setLevel(logging.INFO)  # the run's log file takes every line
        return self

    def __exit__(self, *exc):
        log.removeHandler(self.handler)
        self.handler.close()


def train(cfg, tag: str = "train", device="cuda") -> Dict[str, object]:
    """Train from a seeded init for TRAIN.NUM_EPOCHS epochs. Returns the epochs
    and steps taken, the last losses, the last validation's metrics (with
    TRAIN.VALIDATE), the last checkpoint and the run's directory."""
    device = resolve_device(device)
    check_trainer_options(cfg, evaluates=cfg.TRAIN.VALIDATE)
    loader = train_loader(cfg)
    val = eval_loader(cfg) if cfg.TRAIN.VALIDATE else None
    state = pipeline(cfg).state(cfg, len(loader.dataset), device)
    with _RunDir(cfg, tag, ["checkpoints"]) as run:
        log.info("Training begins: %s, %d train clips, %d steps an epoch, device %s",
                 cfg.PIPELINE_TYPE, len(loader.dataset), len(loader), state.device)
        global_step, checkpoint, losses, metrics = 0, None, {}, {}
        for epoch in range(1, cfg.TRAIN.NUM_EPOCHS + 1):
            tic = time.perf_counter()
            steps, losses = train_epoch(state, loader, epoch, global_step, run.path)
            global_step += steps
            if epoch % cfg.TRAIN.CHECKPOINT_INTERVAL == 0:
                checkpoint = os.path.join(run.path, "checkpoints",
                                          f"checkpoint_epoch-{epoch}_step-{global_step}.pth")
                state.save_checkpoint(checkpoint, epoch, global_step)
                log.info("Saved checkpoint to: %s", checkpoint)
                if val is not None:
                    log.info("Validation begins!")
                    metrics = evaluate(state, val, epoch, run.path)
            if state.device.type == "cuda":
                torch.cuda.synchronize(state.device)  # the epoch's time is the card's too
            log.info("[TRAIN] epoch %d/%d: %d steps in %.3f s", epoch,
                     cfg.TRAIN.NUM_EPOCHS, steps, time.perf_counter() - tic)
    out = {"epochs": cfg.TRAIN.NUM_EPOCHS, "steps": global_step,
           "losses": {k: float(v) for k, v in losses.items()},
           "checkpoint": checkpoint, "output_dir": run.path}
    if val is not None:
        out["val_metrics"] = metrics
    return out


def test(cfg, checkpoint: str, tag: str = "test", device="cuda") -> Dict[str, object]:
    """Evaluate a reference-layout ``.pth`` on the val split (the JAX
    ``--test_only``). Returns the metrics, the sample count, the checkpoint
    and the run's directory."""
    device = resolve_device(device)
    check_trainer_options(cfg, evaluates=True)
    if not str(checkpoint).endswith((".pth", ".pt")):
        raise ValueError(f"--checkpoint {checkpoint!r}: the port reads reference-layout "
                         ".pth checkpoints")
    loader = eval_loader(cfg)
    state = pipeline(cfg).state(cfg, None, device)
    state.load_pth(checkpoint)
    with _RunDir(cfg, tag) as run:
        log.info("Testing begins: %s from %s, %d clips, device %s", cfg.PIPELINE_TYPE,
                 checkpoint, len(loader.dataset), state.device)
        metrics = evaluate(state, loader, 0, run.path)
    return {"metrics": metrics, "num_samples": len(loader.dataset),
            "checkpoint": checkpoint, "output_dir": run.path}
