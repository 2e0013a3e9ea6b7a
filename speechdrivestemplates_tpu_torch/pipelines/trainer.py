"""The training loop, validation and the test run, for both pipelines.

Counterpart of the JAX package's ``Trainer`` (``pipelines/trainer.py``);
``PIPELINE_TYPE`` picks Voice2Pose or Pose2Pose. A run writes
into ``<SYS.OUTPUT_DIR>/<datetime>_<tag>/`` (``main.py`` passes JAX's
``<cfg_name>-{TRAIN,TEST,DEMO}-<tag>``): the log ``<tag>.log``; a
TensorBoard event file (``utils/tb_native.py``: ``train/lr_<k>`` and
``train/<loss>`` every SYS.LOG_INTERVAL steps, ``train/epoch_time``,
``train/ETA`` and the ``train/clip_code`` figure per epoch, ``val/<metric>``,
``test/<metric>``); with TRAIN.SAVE_VIDEO / TEST.SAVE_VIDEO, beside each
result archive's step, the pose video of clip 0 (pred | gt in training and
evaluation, the prediction and its filmstrip in the demo) into the sinks of
SYS.VIDEO_FORMAT (``utils/video.py``: ``train/video``,
``{val,test}/video/<step>``, ``videos/*.mp4`` and ``.wav``, ``imgs/*.jpg``);
in training,
every TRAIN.CHECKPOINT_INTERVAL epochs, after the validation (TRAIN.VALIDATE)
``checkpoints/checkpoint_epoch-E_step-S.pth`` in the reference layout and its
resume file (``pipelines/checkpoint.py``); with TRAIN.SAVE_NPZ /
TEST.SAVE_NPZ, ``results/epoch{E}-{TAG}-step{S}.npz`` archives of a few
steps' results. An evaluation (``validate``, ``test``) weights each batch's
losses by its true sample count, so the ragged last batch counts as what it
holds, and adds the FGD of the pose encoder's latents (Voice2Pose).

A run continues another: ``resume_from`` (a checkpoint, its run directory or
its ``checkpoints/``; weights and resume file, into the same directory), or
TRAIN.AUTO_RESUME (this tag's newest checkpoint that loads). TRAIN.PRETRAIN_FROM
starts a new run from a ``.pth``'s weights with fresh optimizers. With
TRAIN.CHECKPOINT_ON_PREEMPT a SIGTERM ends the run after the step (or chunk)
in flight with a checkpoint stamped (epoch - 1, global step) and exit code
143. Batches reach the card from page-locked memory, the next one's copy
enqueued a step ahead; with DATASET.CACHING and DATASET.DEVICE_CACHE the
train set is staged on the card once and a step's batch is one gather there;
TRAIN.STEPS_PER_DISPATCH = K > 1 runs K steps in one CUDA graph
(``pipelines/graphed.py``). SYS.PROFILE opens a ``torch.profiler`` window.

``demo`` is the JAX ``--demo_input``: the demo split of a wav, a list of wavs
or a directory, one clip at a time through the pipeline's ``demo_step``,
DEMO.MULTIPLE times a clip (the code moved from DEMO.CODE_INDEX towards
DEMO.CODE_INDEX_B by i / (MULTIPLE - 1)), each result archived with
TEST.SAVE_NPZ as ``results/epoch0-DEMO-step{t}[-{i}].npz``.

Under a process group (``parallel/dist.py``; ``main.py`` starts the ranks)
every rank runs the same function on its shard of the data, as the JAX
trainer's processes do: the train and eval loaders take JAX's shards
(``datasets.gesture_dataset.shard_indices``) at TRAIN.BATCH_SIZE // world and
TEST.BATCH_SIZE // world a rank; the steps compute the global batch's losses,
statistics and gradients; an evaluation weights each batch by its global
sample count and gathers every rank's FGD features, so every rank ends with
the same metrics. Rank 0 alone makes the run directory and writes its log
file, TensorBoard, videos, result archives, figures and checkpoints (every
rank waits for each checkpoint), and makes TRAIN.AUTO_RESUME's choice, which
it hands to the others; every rank loads the same checkpoint. The preemption
flag is agreed over ranks at each step, so every rank stamps the same (epoch,
step). The device cache and the K-step CUDA graph stay off (each rank keeps
its loader shard). The demo runs on every rank (the sequence-parallel route,
DEMO.SEQUENCE_PARALLEL, splits the clip's time axis over them); rank 0 writes
its archives and videos.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from datetime import datetime
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import check_config
from ..datasets.gesture_dataset import (CachedLoader, EpochBatches, GestureDataset, collate,
                                        shard_indices, to_torch)
from ..ops.fgd import compute_fgd
from ..parallel import dist as pdist
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.tb_native import NativeTBWriter
from ..utils.video import VideoWriter
from ..utils.viz import draw_pose_frames_in_long_img
from ..utils.weights import read_pth
from . import pose2pose, voice2pose
from .checkpoint import (checkpoint_name, find_auto_resume_candidates, read_resume,
                         resolve_checkpoint, resume_path, save_checkpoint)
from .graphed import ChunkRunner, index_tensor

log = logging.getLogger(__name__)
PORT_LOG = logging.getLogger(__name__.split(".")[0])  # a run's log file takes the port's lines

PIPELINES = {
    "Voice2Pose": SimpleNamespace(state=voice2pose.Voice2PoseTrainState,
                                  train_step=voice2pose.train_step,
                                  eval_step=voice2pose.eval_step,
                                  demo_step=voice2pose.demo_step,
                                  draw_figure_epoch=voice2pose.draw_figure_epoch,
                                  device_keys=voice2pose.DEVICE_KEYS),
    "Pose2Pose": SimpleNamespace(state=pose2pose.Pose2PoseTrainState,
                                 train_step=pose2pose.train_step,
                                 eval_step=pose2pose.eval_step,
                                 demo_step=pose2pose.demo_step,
                                 draw_figure_epoch=pose2pose.draw_figure_epoch,
                                 device_keys=pose2pose.DEVICE_KEYS),
}
FGD_KEYS = ("mu_pred", "logvar_pred", "mu_gt", "logvar_gt")
DEVICE_CACHE_MODES = ("auto", "on", "off")


def pipeline(cfg) -> SimpleNamespace:
    if cfg.PIPELINE_TYPE not in PIPELINES:
        raise ValueError(f"PIPELINE_TYPE {cfg.PIPELINE_TYPE!r}: the port has "
                         f"{sorted(PIPELINES)}")
    return PIPELINES[cfg.PIPELINE_TYPE]


def check_trainer_options(cfg, evaluates: bool, demo: bool = False) -> None:
    """Raise for an option the run cannot take: ValueError for an unknown
    pipeline or option value (``config.check_config``), and ImportError
    where the run saves videos (TEST.SAVE_VIDEO where it evaluates or is a
    demo, TRAIN.SAVE_VIDEO where it trains) and cv2 does not import."""
    pipeline(cfg)
    check_config(cfg)
    videos = ((cfg.TRAIN.SAVE_VIDEO and not demo)
              or (cfg.TEST.SAVE_VIDEO and (evaluates or demo)))
    if videos and cfg.SYS.VIDEO_FORMAT:
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise ImportError(f"pose videos (TRAIN.SAVE_VIDEO, TEST.SAVE_VIDEO) are drawn with "
                              f"cv2, which does not import ({e}); pass them False") from e
    if cfg.DATASET.DEVICE_CACHE not in DEVICE_CACHE_MODES:
        raise ValueError(f"DATASET.DEVICE_CACHE {cfg.DATASET.DEVICE_CACHE!r}: one of "
                         f"{DEVICE_CACHE_MODES}")
    if cfg.TRAIN.STEPS_PER_DISPATCH < 1:
        raise ValueError(f"TRAIN.STEPS_PER_DISPATCH {cfg.TRAIN.STEPS_PER_DISPATCH}: >= 1")


def rank_batch(batch_size: int, what: str) -> int:
    """A rank's share of the global ``batch_size`` (JAX: ``batch_size //
    process_count``); the whole of it without a process group."""
    world = pdist.world_size()
    if batch_size < world:
        raise ValueError(f"{what} {batch_size} is less than the {world} ranks: each needs a "
                         "sample a batch")
    return batch_size // world


def train_loader(cfg, device=None):
    """The train split in the JAX loader's batches (``loader.batch_sampler
    .set_epoch`` picks the epoch's shuffle), this rank's shard of them under
    a process group: with DATASET.CACHING a ``CachedLoader`` over the split's
    SoA arrays, else SYS.NUM_WORKERS worker processes that live as long as
    the loader. Batches for the card (``device``) come in page-locked
    memory. The dataset builds and loads the native item loader when it is
    made, here, so the workers fork with it built (``datasets/
    native_loader.py``; the eval loader and the device cache's
    ``materialize`` read through the same datasets)."""
    dataset = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg)
    bs = rank_batch(cfg.TRAIN.BATCH_SIZE, "TRAIN.BATCH_SIZE")
    if -(-len(dataset) // pdist.world_size()) < bs:
        raise ValueError(f"{len(dataset)} train clips make no full batch of "
                         f"TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE}")
    pin = device is not None and torch.device(device).type == "cuda"
    batches = EpochBatches(len(dataset), bs, cfg.SYS.SEED, pdist.world_size(), pdist.rank())
    if cfg.DATASET.CACHING:
        return CachedLoader(dataset, batches, pin)
    workers = cfg.SYS.NUM_WORKERS
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=batches, collate_fn=collate, num_workers=workers,
        persistent_workers=workers > 0, pin_memory=pin)


def eval_loader(cfg) -> torch.utils.data.DataLoader:
    """The val split in order, TEST.BATCH_SIZE a batch, the ragged last batch
    kept (the JAX eval loader: no shuffle, no drop); under a process group
    this rank's shard of it (``shard_indices``: the padded duplicates are
    JAX's) at TEST.BATCH_SIZE // world a batch."""
    dataset = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg, split="val")
    if not len(dataset):
        raise ValueError(f"no val ('dev') clips for speaker {cfg.DATASET.SPEAKER!r} under "
                         f"{cfg.DATASET.ROOT_DIR}")
    bs = rank_batch(cfg.TEST.BATCH_SIZE, "TEST.BATCH_SIZE")
    sampler = None
    if pdist.distributed():
        sampler = shard_indices(len(dataset), pdist.world_size(), pdist.rank()).tolist()
    return torch.utils.data.DataLoader(
        dataset, batch_size=bs, sampler=sampler, shuffle=False, drop_last=False,
        collate_fn=collate, num_workers=cfg.SYS.NUM_WORKERS)


def _to_device(batch, device):
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return batch.to(device, non_blocking=True)


def device_cache_reason(cfg, loader, device_keys) -> str:
    """'' when the train set can be staged on the device for ``loader``, else
    the reason it cannot (the JAX ``_device_cache_eligible``)."""
    if cfg.DATASET.DEVICE_CACHE == "off":
        return "DATASET.DEVICE_CACHE off"
    if getattr(loader.dataset, "split", None) != "train":
        return "not the train loader"
    if not device_keys:
        return "pipeline declares no device keys"
    if not cfg.DATASET.CACHING:
        return "needs DATASET.CACHING (SoA arrays)"
    if cfg.TRAIN.SAVE_VIDEO or cfg.TRAIN.SAVE_NPZ:
        return "per-step artifact saving needs host batches"
    if pdist.distributed():
        return "multi-process runs keep per-host loader shards"
    return ""


def stage_device_cache(cfg, loader, device, device_keys) -> Tuple[Optional[dict], str]:
    """The train split's ``device_keys`` (those its items have) as tensors on
    ``device``, staged once for the run, and the line to log; ``(None, why)``
    where the cache cannot engage (DATASET.DEVICE_CACHE 'auto'). 'on' raises
    ValueError instead."""
    reason = device_cache_reason(cfg, loader, device_keys)
    if not reason:
        soa = loader.dataset.materialize()
        host = {k: soa[k] for k in device_keys if k in soa}
        nbytes = sum(a.nbytes for v in host.values()
                     for a in (v.values() if isinstance(v, dict) else [v]))
        limit = cfg.DATASET.DEVICE_CACHE_MAX_MB * 1e6
        if nbytes > limit:
            reason = (f"train set ({nbytes / 1e6:.0f} MB) exceeds "
                      f"DATASET.DEVICE_CACHE_MAX_MB ({limit / 1e6:.0f} MB)")
    if reason:
        if cfg.DATASET.DEVICE_CACHE == "on":
            raise ValueError(f"DATASET.DEVICE_CACHE on, but: {reason}")
        return None, f"device cache disabled: {reason}"
    return _to_device(to_torch(host), device), (
        f"device-resident train cache engaged: {nbytes / 1e6:.0f} MB on {device}, "
        "per-step host traffic = one (B,) index array")


def device_prefetch(loader, device):
    """The loader's batches on ``device``, the next batch's host-to-device copy
    enqueued before the current batch is handed out (the JAX
    ``_device_prefetch``). The copies go on the current stream from the
    loader's page-locked memory: the host never waits for them, and the
    step that reads a batch is queued after its copy."""
    if torch.device(device).type != "cuda":
        yield from loader
        return
    prev = None
    for batch in loader:
        nxt = _to_device(batch, device)
        if prev is not None:
            yield prev
        prev = nxt
    if prev is not None:
        yield prev


def save_results(base_path: str, tag: str, step: int, epoch: int,
                 results: Dict[str, torch.Tensor], extra_id: Optional[int] = None) -> str:
    """``results/epoch{E}-{TAG}-step{S}[-{extra_id}].npz`` under the run's
    directory, each result as float32."""
    res_dir = os.path.join(base_path, "results")
    os.makedirs(res_dir, exist_ok=True)
    suffix = "" if extra_id is None else f"-{extra_id}"
    path = os.path.join(res_dir, f"epoch{epoch}-{tag}-step{step}{suffix}.npz")
    np.savez(path, **{k: v.detach().float().cpu().numpy() for k, v in results.items()})
    return path


def _line(values: Dict[str, object]) -> str:
    return "".join(f"{k}: {float(v):.5f}  " for k, v in values.items())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def save_pair_video(video: VideoWriter, cfg, tag: str, step: int, epoch: int,
                    global_step: Optional[int], batch, results, writer, base_path: str) -> None:
    """Clip 0's pred | gt video and audio, fetched alone from the device, to
    the run's video sinks (the JAX ``_save_step_artifacts``' video)."""
    frames = voice2pose.generate_video_pair(cfg, _host(results["poses_pred_batch"][0]),
                                            _host(results["poses_gt_batch"][0]))
    audio = batch.get("audio")
    video.save_video(cfg, tag, frames, step, epoch, global_step,
                     audio=None if audio is None else _host(audio[0]), writer=writer,
                     base_path=base_path)


def save_demo_video(video: VideoWriter, cfg, step: int, batch, results, writer, base_path: str,
                    extra_id: Optional[int] = None) -> None:
    """Clip 0's predicted video, its filmstrip and its audio to the run's
    video sinks (the JAX ``demo_step``'s video)."""
    pred = _host(results["poses_pred_batch"][0])
    audio = batch.get("audio")
    video.save_video(cfg, "DEMO", voice2pose.generate_video(cfg, pred), step, 0,
                     long_img=draw_pose_frames_in_long_img(pred.transpose(0, 2, 1)),
                     audio=None if audio is None else _host(audio[0]), writer=writer,
                     base_path=base_path, extra_id=extra_id)


def epoch_figures(p, state) -> Dict[str, object]:
    """The pipeline's figures at an epoch's end (``{}`` and a log line where
    matplotlib does not import)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        log.info("[TRAIN] epoch plotting: skipped, matplotlib does not import (%s)", e)
        return {}
    figures = p.draw_figure_epoch(state)
    log.info("[TRAIN] epoch plotting: %s", ", ".join(figures) or "nothing")
    return figures


class Preemption:
    """With TRAIN.CHECKPOINT_ON_PREEMPT, a SIGTERM handler that sets ``flag``;
    the old handler comes back on exit. A non-main thread cannot install one
    (ValueError) and runs without it, as in JAX. Ranks agree on the flag
    (``TrainLoop._check_preempt``), as JAX's hosts do with an allgather."""

    def __init__(self, enabled: bool):
        self.enabled, self.flag, self.old, self.installed = enabled, False, None, False

    def _on_sigterm(self, signum, frame) -> None:
        self.flag = True
        log.warning("SIGTERM received: will checkpoint after the in-flight step and exit")

    def __enter__(self):
        if self.enabled:
            try:
                self.old = signal.signal(signal.SIGTERM, self._on_sigterm)
                self.installed = True
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        if self.installed:
            signal.signal(signal.SIGTERM, self.old if self.old is not None else signal.SIG_DFL)


class Profiler:
    """SYS.PROFILE: a ``torch.profiler`` window (host and, on the card, CUDA
    activity) over the global steps [START_STEP, START_STEP + NUM_STEPS),
    opened and closed by range at the steps ``at`` sees, so under
    TRAIN.STEPS_PER_DISPATCH on chunk boundaries (the JAX ``_maybe_profile``).
    The Chrome trace goes to OUT_DIR or ``<run>/profile``, with the window's
    port spans (``utils/trace.py``) on a row of their own."""

    def __init__(self, cfg, base_path: Optional[str], device: torch.device):
        self.cfg, self.device, self.prof, self.first = cfg.SYS.PROFILE, device, None, 0
        self.out = self.cfg.OUT_DIR or os.path.join(base_path or ".", "profile")

    def at(self, global_step: int) -> None:
        if not self.cfg.ENABLED or not pdist.is_master():  # rank 0's trace, as in JAX
            return
        start, end = self.cfg.START_STEP, self.cfg.START_STEP + self.cfg.NUM_STEPS
        if self.prof is None and start <= global_step < end:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            os.makedirs(self.out, exist_ok=True)
            self.prof, self.first = profile(activities=acts), global_step
            self.prof.start()
            trace.reset()
            log.info("starting torch.profiler trace at global step %d -> %s", global_step,
                     self.out)
        elif self.prof is not None and global_step >= end:
            self.close(global_step - 1)

    def close(self, last_step: int) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        path = os.path.join(self.out, f"trace_steps-{self.first}-{last_step}.json")
        self.prof.export_chrome_trace(path)
        trace.add_to_chrome_trace(path)
        self.prof = None
        log.info("stopped torch.profiler trace: %s", path)


def checkpoint_path(base_path: str, epoch: int, global_step: int) -> str:
    return os.path.join(base_path, "checkpoints", checkpoint_name(epoch, global_step))


class TrainLoop:
    """The epochs of one run over ``loader``: each batch through the
    pipeline's train step, from the host (prefetched to the card) or, with
    ``cache`` (``stage_device_cache``), gathered on the device in chunks of
    ``chunk`` steps (CUDA graphs on the card when ``chunk`` > 1, see
    ``pipelines/graphed.py``). A log line (and TensorBoard scalars into
    ``writer``) every SYS.LOG_INTERVAL steps; TRAIN.NUM_RESULT_SAMPLE result
    archives with TRAIN.SAVE_NPZ; a preemption check after every step or
    chunk; the profiler window; the schedulers' step at the epoch's end. With
    ``collect``, ``history`` keeps every step's loss row (device tensors, in
    ``names``' order). With TRAIN.SAVE_VIDEO and ``video``, a pair video at
    each result archive's step (never from the device cache, which declines
    while videos are saved)."""

    def __init__(self, state, loader, cache: Optional[dict] = None, chunk: int = 1,
                 base_path: Optional[str] = None, writer=None,
                 preempt: Optional[Preemption] = None, profiler: Optional[Profiler] = None,
                 collect: bool = False, video: Optional[VideoWriter] = None):
        self.state, self.loader, self.cache = state, loader, cache
        self.cfg = state.cfg
        self.step_fn = pipeline(self.cfg).train_step
        self.base_path, self.writer, self.preempt = base_path, writer, preempt
        self.video = video
        self.profiler = profiler or Profiler(self.cfg, base_path, state.device)
        self.chunk = chunk if cache is not None else 1
        self.runner = None if cache is None else ChunkRunner(
            state, self.step_fn, cache, graphed=self.chunk > 1 and state.device.type == "cuda")
        self.history = [] if collect else None
        self.names = None
        self.tic = time.perf_counter()

    def epoch(self, epoch: int, global_step: int = 0) -> Tuple[int, Dict[str, torch.Tensor]]:
        """One epoch (``epoch`` counts from 1) from ``global_step``; returns
        the global step after it and the last step's losses."""
        self.loader.batch_sampler.set_epoch(epoch)
        self.tic = time.perf_counter()
        if self.runner is not None:
            global_step, losses = self._chunks(epoch, global_step)
        else:
            global_step, losses = self._steps(epoch, global_step)
        self.state.end_epoch()
        return global_step, losses

    def _steps(self, epoch, global_step):
        cfg, n = self.cfg, len(self.loader)
        every = max(1, n // cfg.TRAIN.NUM_RESULT_SAMPLE)
        losses: Dict[str, torch.Tensor] = {}
        for t, batch in enumerate(device_prefetch(self.loader, self.state.device), 1):
            global_step += 1
            self.profiler.at(global_step)
            losses, results = self.step_fn(self.state, batch)
            if self.history is not None:
                self.names = self.names or list(losses)
                self.history.append(torch.stack([losses[k].float() for k in self.names])[None])
            if t % cfg.SYS.LOG_INTERVAL == 0:
                self._log_step(epoch, t, n, global_step, losses)
            if self.base_path is not None and t % every == 0:
                if cfg.TRAIN.SAVE_NPZ:
                    save_results(self.base_path, "TRAIN", t, epoch, results)
                if cfg.TRAIN.SAVE_VIDEO and self.video is not None:
                    save_pair_video(self.video, cfg, "TRAIN", t, epoch, global_step, batch,
                                    results, self.writer, self.base_path)
            self._check_preempt(epoch, global_step)
        return global_step, losses

    def _chunks(self, epoch, global_step):
        cfg, li = self.cfg, self.cfg.SYS.LOG_INTERVAL
        schedule = index_tensor(np.stack(self.loader.batch_sampler.index_batches()),
                                self.state.device)  # the epoch's (n, B) indices, copied once
        n, t, losses = len(schedule), 0, {}
        for c0 in range(0, n, self.chunk):
            chunk = schedule[c0:c0 + self.chunk]
            self.profiler.at(global_step + 1)
            rows = self.runner.run(chunk)
            self.names = self.runner.names
            if self.history is not None:
                self.history.append(rows)
            logged = [j for j in range(len(chunk)) if (t + j + 1) % li == 0]
            if logged:
                host = rows[logged].cpu()
                for i, j in enumerate(logged):
                    self._log_step(epoch, t + j + 1, n, global_step + j + 1,
                                   dict(zip(self.names, host[i])))
            losses = dict(zip(self.names, rows[-1]))
            t += len(chunk)
            global_step += len(chunk)
            self._check_preempt(epoch, global_step)
        return global_step, losses

    def _log_step(self, epoch, t, n, global_step, losses) -> None:
        cfg = self.cfg
        per_step = (time.perf_counter() - self.tic) / cfg.SYS.LOG_INTERVAL
        self.tic = time.perf_counter()
        lrs = self.state.learning_rates()
        values = {k: float(v) for k, v in losses.items()}
        msg = (f"[TRAIN] epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  step: {t}/{n}  "
               f"global_step: {global_step}  time: {per_step:.3f}  ")
        msg += "".join(f"lr_{k}: {lr:.1e}  " for k, lr in lrs.items())
        log.info(msg + _line(values))
        if self.writer is not None:
            for k, lr in lrs.items():
                self.writer.add_scalar(f"train/lr_{k}", lr, global_step)
            for k, v in values.items():
                self.writer.add_scalar(f"train/{k}", v, global_step)

    def _check_preempt(self, epoch: int, global_step: int) -> None:
        # under a process group every rank asks at every step (a collective):
        # the ranks stop at the same step, whichever of them got the signal
        if self.preempt is None or not self.preempt.enabled or not pdist.agree(self.preempt.flag):
            return
        # stamped epoch - 1: a resume redoes the interrupted epoch from its start
        path = None if self.base_path is None else checkpoint_path(self.base_path, epoch - 1,
                                                                   global_step)
        save_rank0(self.state, path, epoch - 1, global_step)
        log.warning("Preemption checkpoint saved (epoch %d, step %d); exiting 143",
                    epoch - 1, global_step)
        raise SystemExit(143)


def evaluate(state, loader: torch.utils.data.DataLoader, epoch: int = 0,
             base_path: Optional[str] = None, writer=None,
             video: Optional[VideoWriter] = None) -> Dict[str, float]:
    """One pass of the pipeline's eval step over ``loader`` (epoch 0: a test
    run, tagged TEST; else a validation, VAL). Returns the epoch's losses and
    metrics, each batch weighted by its true sample count, and FGD_mu and
    FGD_mu_logvar when the pipeline gives pose-encoder latents; each goes to
    ``writer`` as ``val/<k>`` or ``test/<k>`` at step ``epoch``. With
    TEST.SAVE_VIDEO and ``video``, a pair video at each result archive's
    step. ``loader`` is a ``DataLoader`` of the split, whose size divides the
    weighted sums, or any iterable of batches (the rows it holds divide).
    Under a process group it is this rank's shard: each batch's global
    losses weigh its global sample count (the rank's times the ranks, JAX's
    weight, the shard padding's duplicates included), and the FGD features
    are every rank's."""
    cfg = state.cfg
    tag = "TEST" if epoch == 0 else "VAL"
    eval_fn = pipeline(cfg).eval_step
    n_batches = len(loader)
    every = max(1, n_batches // cfg.TEST.NUM_RESULT_SAMPLE)
    sums: Dict[str, torch.Tensor] = {}
    latents: Dict[str, list] = {k: [] for k in FGD_KEYS}
    rows, tic = 0, time.perf_counter()
    for t, batch in enumerate(loader, 1):
        true_bs = batch["poses"].shape[0] * pdist.world_size()
        rows += true_bs
        losses, results = eval_fn(state, batch, sharded=True)
        for k, v in losses.items():
            sums[k] = sums[k] + v.double() * true_bs if k in sums else v.double() * true_bs
        for k in FGD_KEYS:
            if k in results:
                latents[k].append(results[k].float())
        if t % cfg.SYS.LOG_INTERVAL == 0:
            log.info(f"[{tag}] epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  step: {t}/{n_batches}  "
                     + _line(losses))
        if base_path is not None and t % every == 0:
            if cfg.TEST.SAVE_NPZ:
                save_results(base_path, tag, t, epoch, results)
            if cfg.TEST.SAVE_VIDEO and video is not None:
                save_pair_video(video, cfg, tag, t, epoch, None, batch, results, writer,
                                base_path)
    # JAX divides by the split's size (the shard padding's rows weigh in); an
    # iterable of batches without a dataset by the rows it held
    num = len(loader.dataset) if isinstance(loader, torch.utils.data.DataLoader) else rows
    metrics = {k: float(v) / num for k, v in sums.items()}
    if all(latents[k] for k in FGD_KEYS):
        lat = {k: pdist.gather_rows(torch.cat(v)).cpu().numpy() for k, v in latents.items()}
        metrics["FGD_mu"] = compute_fgd(lat["mu_pred"], lat["mu_gt"])
        metrics["FGD_mu_logvar"] = compute_fgd(
            np.concatenate([lat["mu_pred"], lat["logvar_pred"]], 1),
            np.concatenate([lat["mu_gt"], lat["logvar_gt"]], 1))
    counter = f"epoch: {epoch}/{cfg.TRAIN.NUM_EPOCHS}  " if tag == "VAL" else ""
    log.info(f"[{tag}] {counter}val_time: {(time.perf_counter() - tic) / 60:.1f} min  "
             f"num_samples: {num}  " + _line(metrics))
    if writer is not None:
        for k, v in metrics.items():
            writer.add_scalar(f"{tag.lower()}/{k}", v, epoch)
        writer.flush()
    return metrics


class _RunDir:
    """``<SYS.OUTPUT_DIR>/<datetime>_<tag>/`` (or ``path``, an existing run's
    directory, which a resume writes on into) and its log file, attached to
    the port's logger while the run lasts, its TensorBoard writer and its
    video writer, whose queue is drained when the run ends. Under a process
    group rank 0 alone makes and writes them, and hands the path to the
    other ranks, whose ``writer``, ``video`` and ``out`` (where artifacts
    go) are None."""

    def __init__(self, cfg, tag: str, subdirs=(), path: Optional[str] = None):
        self.cfg = cfg
        self.master = pdist.is_master()
        self.handler = self.writer = self.video = None
        if self.master:
            if path is None:
                stamp = str(datetime.now()).replace(".", "-").replace(":", "-").replace(" ", "_")
                path = os.path.join(cfg.SYS.OUTPUT_DIR, f"{stamp}_{tag}")
                os.makedirs(path)
            for d in subdirs:
                os.makedirs(os.path.join(path, d), exist_ok=True)
            self.handler = logging.FileHandler(os.path.join(path, f"{tag}.log"))
            self.handler.setFormatter(
                logging.Formatter("%(asctime)s [%(levelname)-0.5s] %(message)s"))
        self.path = pdist.broadcast_object(path)
        self.out = self.path if self.master else None

    def __enter__(self):
        if self.master:
            PORT_LOG.addHandler(self.handler)
            PORT_LOG.setLevel(logging.INFO)  # the run's log file takes every line
            self.writer = NativeTBWriter(self.path)
            self.video = VideoWriter(self.cfg)
        return self

    def __exit__(self, *exc):
        if not self.master:
            return
        try:
            self.video.close()  # the queued videos, written before the event file closes
        finally:
            self.writer.close()
            PORT_LOG.removeHandler(self.handler)
            self.handler.close()


def save_rank0(state, path: str, epoch: int, global_step: int) -> None:
    """The checkpoint and its resume file, written by rank 0; every rank
    waits for them."""
    if pdist.is_master():
        save_checkpoint(state, path, epoch, global_step)
    pdist.barrier()


def _auto_resume(cfg, tag: str) -> Optional[str]:
    """TRAIN.AUTO_RESUME: the newest checkpoint of this tag whose ``.pth`` and
    resume file both load; one that does not is skipped with a log line (a
    save cut off mid-write falls back to the one before). Rank 0 chooses
    and hands its choice to the other ranks."""
    if not pdist.is_master():
        return pdist.broadcast_object(None)
    return pdist.broadcast_object(_newest_loadable(cfg, tag))


def _newest_loadable(cfg, tag: str) -> Optional[str]:
    for cand in find_auto_resume_candidates(cfg.SYS.OUTPUT_DIR, tag):
        try:
            read_pth(cand)
            read_resume(cand)
        except Exception as exc:  # noqa: BLE001 - any load failure skips the candidate
            log.warning("AUTO_RESUME: skipping unrestorable checkpoint %s (%s)", cand, exc)
            continue
        log.warning("AUTO_RESUME: continuing from %s", cand)
        return cand
    return None


def _resolve_resume(resume_from: str) -> str:
    """``--resume_from``'s checkpoint; raises where it has no resume file."""
    if not os.path.exists(resume_from):
        raise FileNotFoundError(f"--resume_from {resume_from!r}: not found")
    ckpt = resolve_checkpoint(resume_from)
    if not os.path.exists(resume_path(ckpt)):
        raise ValueError(
            f"--resume_from {ckpt}: no resume file {os.path.basename(resume_path(ckpt))} beside "
            "it, so no optimizer moments, schedulers or step counts to continue with (a .pth "
            "alone, such as a JAX export or a reference checkpoint, holds weights only); use "
            f"--pretrain_from {ckpt} to continue from its weights with fresh optimizers")
    return ckpt


def train(cfg, tag: str = "train", device="cuda",
          resume_from: Optional[str] = None) -> Dict[str, object]:
    """Train for TRAIN.NUM_EPOCHS epochs: from a seeded init, from
    TRAIN.PRETRAIN_FROM's weights, or on from ``resume_from`` (or, with
    TRAIN.AUTO_RESUME, this tag's newest checkpoint). Returns the epochs and
    steps, the last losses, the last validation's metrics (with
    TRAIN.VALIDATE), the last checkpoint, the run's directory, and the
    checkpoint it resumed from where it did."""
    device = resolve_device(device)
    check_trainer_options(cfg, evaluates=cfg.TRAIN.VALIDATE)
    p = pipeline(cfg)
    if resume_from is None and cfg.TRAIN.AUTO_RESUME:
        resume_from = _auto_resume(cfg, tag)
    ckpt = _resolve_resume(resume_from) if resume_from is not None else None
    pretrain = cfg.TRAIN.PRETRAIN_FROM if ckpt is None else None
    if pretrain is not None and not os.path.exists(pretrain):
        raise FileNotFoundError(f"TRAIN.PRETRAIN_FROM {pretrain!r}: not found")
    loader = train_loader(cfg, device)
    val = eval_loader(cfg) if cfg.TRAIN.VALIDATE else None
    cache, cache_line = stage_device_cache(cfg, loader, device, p.device_keys)
    if pdist.distributed():
        cache_line += f"; rank {pdist.rank()} of {pdist.world_size()}"
    K = cfg.TRAIN.STEPS_PER_DISPATCH
    state = p.state(cfg, len(loader.dataset), device,
                    capturable=device.type == "cuda" and K > 1 and cache is not None)
    epoch = global_step = 0
    if ckpt is not None:
        state.load_pth(ckpt)
        resume = read_resume(ckpt)
        state.load_train_state(resume)
        epoch, global_step = int(resume["epoch"]), int(resume["global_step"])
    elif pretrain is not None:
        state.load_pth(pretrain)  # weights only: the optimizers stay fresh
    run_path = os.path.dirname(os.path.dirname(ckpt)) if ckpt is not None else None
    checkpoint, losses, metrics = None, {}, {}
    with _RunDir(cfg, tag, ["checkpoints"], run_path) as run, \
            Preemption(cfg.TRAIN.CHECKPOINT_ON_PREEMPT) as preempt:
        profiler = Profiler(cfg, run.path, state.device)
        if ckpt is not None:
            log.info("Resuming from checkpoint: %s (epoch %d, global step %d)", ckpt, epoch,
                     global_step)
        elif pretrain is not None:
            log.info("Loading from pretrained model: %s", pretrain)
        log.info(cache_line)
        if K > 1 and cache is None:
            log.warning("TRAIN.STEPS_PER_DISPATCH=%d needs the device-resident train cache "
                        "(%s); falling back to one dispatch per step", K,
                        cache_line.split(": ", 1)[1])
        log.info("Training begins: %s, %d train clips, %d steps an epoch, device %s",
                 cfg.PIPELINE_TYPE, len(loader.dataset), len(loader), state.device)
        loop = TrainLoop(state, loader, cache, K, run.out, run.writer, preempt, profiler,
                         video=run.video)
        epoch_times = []
        try:
            while epoch < cfg.TRAIN.NUM_EPOCHS:
                epoch += 1
                tic, start = time.perf_counter(), global_step
                global_step, losses = loop.epoch(epoch, global_step)
                if epoch % cfg.TRAIN.CHECKPOINT_INTERVAL == 0:
                    if val is not None:
                        log.info("Validation begins!")
                        metrics = evaluate(state, val, epoch, run.out, run.writer, run.video)
                    # after the validation, whose draws the resume file's generator holds
                    checkpoint = checkpoint_path(run.path, epoch, global_step)
                    save_rank0(state, checkpoint, epoch, global_step)
                    log.info("Saved checkpoint to: %s", checkpoint)
                if state.device.type == "cuda":
                    torch.cuda.synchronize(state.device)  # the epoch's time is the card's too
                took = time.perf_counter() - tic
                log.info("[TRAIN] epoch %d/%d: %d steps in %.3f s", epoch,
                         cfg.TRAIN.NUM_EPOCHS, global_step - start, took)
                epoch_times.append(took / 3600)
                eta = (cfg.TRAIN.NUM_EPOCHS - epoch) * float(np.mean(epoch_times[-10:]))
                log.info("[TRAIN] epoch_time: %.2f hours  ETA: %.2f hours", took / 3600, eta)
                if run.writer is not None:
                    run.writer.add_scalar("train/epoch_time", took / 3600, epoch)
                    run.writer.add_scalar("train/ETA", eta, epoch)
                    for k, fig in epoch_figures(p, state).items():
                        run.writer.add_figure(f"train/{k}", fig, epoch)
                    run.writer.flush()
        finally:
            profiler.close(global_step)
    out = {"epochs": cfg.TRAIN.NUM_EPOCHS, "steps": global_step,
           "losses": {k: float(v) for k, v in losses.items()},
           "checkpoint": checkpoint, "output_dir": run.path}
    if val is not None:
        out["val_metrics"] = metrics
    if ckpt is not None:
        out["resumed_from"] = ckpt
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
        metrics = evaluate(state, loader, 0, run.out, run.writer, run.video)
    return {"metrics": metrics, "num_samples": len(loader.dataset),
            "checkpoint": checkpoint, "output_dir": run.path}


def demo(cfg, checkpoint: str, demo_input: str, tag: str = "demo",
         device="cuda") -> Dict[str, object]:
    """The demo of a reference-layout ``.pth`` on ``demo_input`` (a wav, a
    space-separated list of wavs, or a directory; the JAX ``--demo_input``).
    Returns the clips' frame counts, the result archives written, the demo's
    seconds (the card synchronized), the checkpoint and the run's
    directory."""
    device = resolve_device(device)
    check_trainer_options(cfg, evaluates=False, demo=True)
    if not str(checkpoint).endswith((".pth", ".pt")):
        raise ValueError(f"--checkpoint {checkpoint!r}: the port reads reference-layout "
                         ".pth checkpoints")
    if cfg.PIPELINE_TYPE == "Pose2Pose" and cfg.DEMO.CODE_PATH is None:
        raise ValueError("the Pose2Pose demo decodes the codes of DEMO.CODE_PATH: set it")
    p = pipeline(cfg)
    dataset = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg, split="demo",
                             demo_input=demo_input)
    if not len(dataset):
        raise ValueError(f"--demo_input {demo_input!r}: no wav")
    loader = torch.utils.data.DataLoader(dataset, batch_size=1, shuffle=False,
                                         collate_fn=collate, num_workers=0)
    state = p.state(cfg, None, device)
    state.load_pth(checkpoint)
    if cfg.PIPELINE_TYPE == "Voice2Pose" and cfg.DEMO.LENGTH_BUCKET_S:
        log.info("DEMO.LENGTH_BUCKET_S %s is ignored: the dense demo runs each clip at its "
                 "own length", cfg.DEMO.LENGTH_BUCKET_S)
    M = cfg.DEMO.MULTIPLE
    passes = [(None, None)] if M <= 1 else [(i, i / (M - 1)) for i in range(M)]
    frames, paths = [], []
    with _RunDir(cfg, tag) as run:
        log.info("Demo begins: %s from %s, %d clips x %d, device %s", cfg.PIPELINE_TYPE,
                 checkpoint, len(dataset), len(passes), state.device)
        tic = time.perf_counter()
        for t, batch in enumerate(loader, 1):
            frames.append(int(batch["num_frames"][0]))
            for extra_id, coeff in passes:
                results = p.demo_step(state, batch, coeff)
                if cfg.TEST.SAVE_NPZ and run.out is not None:
                    paths.append(save_results(run.out, "DEMO", t, 0, results, extra_id))
                if cfg.TEST.SAVE_VIDEO and run.out is not None:
                    save_demo_video(run.video, cfg, t, batch, results, run.writer, run.out,
                                    extra_id)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        took = time.perf_counter() - tic
        log.info("[DEMO] %d clips (%s frames) in %.3f s", len(frames), frames, took)
    return {"num_frames": frames, "npz": paths, "seconds": took, "checkpoint": checkpoint,
            "output_dir": run.path}
