"""The training loop: epochs of train steps, log lines, checkpoints.

Counterpart of the JAX package's ``Trainer.train`` (``pipelines/trainer.py``),
single process. A run writes into ``<SYS.OUTPUT_DIR>/<datetime>_<tag>/``: the
log ``<tag>.log`` and, every TRAIN.CHECKPOINT_INTERVAL epochs,
``checkpoints/checkpoint_epoch-E_step-S.pth`` in the reference layout
(``Voice2PoseTrainState.save_checkpoint``), which the serving command line
loads. Validation, per-step artifacts and resume are not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import datetime
from typing import Dict, Tuple

import torch

from ..datasets.gesture_dataset import EpochBatches, GestureDataset, collate
from .voice2pose import Voice2PoseTrainState, check_supported, train_step

log = logging.getLogger(__name__)


def check_trainer_options(cfg) -> None:
    """Raise NotImplementedError for the trainer options this port lacks."""
    todo = {"TRAIN.VALIDATE": ("validation and FGD", 10),
            "TRAIN.SAVE_VIDEO": ("pose videos", 13),
            "TRAIN.SAVE_NPZ": ("per-step result archives", 9)}
    for key, (what, item) in todo.items():
        if getattr(cfg.TRAIN, key.split(".")[1]):
            raise NotImplementedError(f"{key} True ({what}) is not ported yet: ROADMAP.md "
                                      f"queue A, item {item}; pass {key} False")


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


def train_epoch(state: Voice2PoseTrainState, loader: torch.utils.data.DataLoader,
                epoch: int, global_step: int = 0) -> Tuple[int, Dict[str, torch.Tensor]]:
    """One epoch (``epoch`` counts from 1): every batch through ``train_step``,
    a log line every SYS.LOG_INTERVAL steps, then the schedulers' step.
    Returns the steps taken and the last step's losses."""
    cfg = state.cfg
    loader.batch_sampler.set_epoch(epoch)
    n, tic = len(loader), time.perf_counter()
    losses: Dict[str, torch.Tensor] = {}
    for t, batch in enumerate(loader, 1):
        losses, _ = train_step(state, batch)
        if t % cfg.SYS.LOG_INTERVAL == 0:
            per_step = (time.perf_counter() - tic) / cfg.SYS.LOG_INTERVAL
            tic = time.perf_counter()
            msg = (f"[TRAIN] epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  step: {t}/{n}  "
                   f"global_step: {global_step + t}  time: {per_step:.3f}  ")
            msg += "".join(f"lr_{k}: {lr:.1e}  " for k, lr in state.learning_rates().items())
            msg += "".join(f"{k}: {float(v):.5f}  " for k, v in losses.items())
            log.info(msg)
    state.end_epoch()
    return n, losses


def train(cfg, tag: str = "train", device="cuda") -> Dict[str, object]:
    """Train from a seeded init for TRAIN.NUM_EPOCHS epochs. Returns the epochs
    and steps taken, the last losses, the last checkpoint and the run's
    directory."""
    check_trainer_options(cfg)
    check_supported(cfg)
    loader = train_loader(cfg)
    state = Voice2PoseTrainState(cfg, len(loader.dataset), device)
    stamp = str(datetime.now()).replace(".", "-").replace(":", "-").replace(" ", "_")
    base = os.path.join(cfg.SYS.OUTPUT_DIR, f"{stamp}_{tag}")
    os.makedirs(os.path.join(base, "checkpoints"))
    handler = logging.FileHandler(os.path.join(base, f"{tag}.log"))
    handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)-0.5s] %(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)  # the run's log file takes every line
    try:
        log.info("Training begins: %d train clips, %d steps an epoch, device %s",
                 len(loader.dataset), len(loader), state.device)
        global_step, checkpoint, losses = 0, None, {}
        for epoch in range(1, cfg.TRAIN.NUM_EPOCHS + 1):
            tic = time.perf_counter()
            steps, losses = train_epoch(state, loader, epoch, global_step)
            global_step += steps
            if epoch % cfg.TRAIN.CHECKPOINT_INTERVAL == 0:
                checkpoint = os.path.join(base, "checkpoints",
                                          f"checkpoint_epoch-{epoch}_step-{global_step}.pth")
                state.save_checkpoint(checkpoint, epoch, global_step)
                log.info("Saved checkpoint to: %s", checkpoint)
            if state.device.type == "cuda":
                torch.cuda.synchronize(state.device)  # the epoch's time is the card's too
            log.info("[TRAIN] epoch %d/%d: %d steps in %.3f s", epoch,
                     cfg.TRAIN.NUM_EPOCHS, steps, time.perf_counter() - tic)
    finally:
        log.removeHandler(handler)
        handler.close()
    return {"epochs": cfg.TRAIN.NUM_EPOCHS, "steps": global_step,
            "losses": {k: float(v) for k, v in losses.items()},
            "checkpoint": checkpoint, "output_dir": base}
