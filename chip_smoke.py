#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device   a CUDA device is present; its name and power limit are printed
  2. build    the CUDA kernels compile from speechdrivestemplates_tpu_torch/csrc
  3. mel      the fused STFT+mel kernel vs its plain PyTorch version at (128, 68267), on
              a normal input and on one with 60 dB between its loud and quiet halves,
              whose quiet frames are also held relatively
  4. conv1    the fused conv1+IN1 kernel vs its plain version at (128, 80, 427): fp32
              at rtol/atol 2e-5 on a normal mel and on one offset by 100 (where fp32
              moments would lose digits), zero rows 0 and 81, bf16 within 2e-2 mean
              relative error
  5. stem     the stem (conv1 kernel, then the fused stem kernel) vs its plain version at
              (128, 80, 427), in fp32 (tight tolerance) and in bf16 (the serving dtype);
              the stem kernel alone vs its plain version on one activation, its fp32
              path at the tight tolerance and its bf16 path against the plain bf16 tail
  6. shift    the tap-shift probe kernel, aligned and subtile, vs its plain version at
              (128, 4480, C) x (9, C, C) for C = 64 and 128, within one bf16 rounding
  7. serve    SDT-BP, bf16, full width, seeded weights: three requests (B = 1, 16, 128)
              through build_serving_fn; the mel, conv1 and stem launch counters must read
              1, 2, 3 after the requests (each a signature's first, eager call), in_act's
              21, 42, 63 (once an IN layer after the stem); the B=128 request called twice
              more (its graph captured and replayed, then replayed) runs each kernel as
              often a call and matches the eager call bit for bit; the B=128 result is
              held to an fp32 all-plain forward; the in_act kernel at SDT-BP's 21 IN
              layer shapes at B = 128 in bf16 against the plain path (within one bf16 ulp
              plus 2e-6 x max(1, |plain|) on every element, the shares one ulp off and
              further reported), its ms over the 21 layers beside the plain path's,
              F.instance_norm's (2-D) and F.layer_norm's (1-D) with F.leaky_relu, and the
              bound
  8. cli      the serving command line on a seeded wav and a reference-layout .pth
  9. probe    the kernel-probe command line (profile_kernels, both probes) in a
              subprocess: rc 0, its JSON line, both of its kernels launched
 10. train    SDT-BP bf16 training at full width, B = 32, on a synthetic speaker of 64
              clips written under build/chip_smoke/: the mel kernel vs its plain
              version on a train batch's audio (32, 68266), with phase 3's gates; one
              step launches the mel kernel once and neither conv1 nor the stem (train
              mode runs the plain stem under autograd), and the stem's weights get
              gradients; at the pre-step weights the bf16 step's G_reg_loss is within
              2% of an fp32 all-plain step's and the two generator gradients have a
              cosine >= 0.99; 30 steps at LR 1e-3 keep every loss finite and bring the
              mean G_reg_loss of the last 4 below that of the first 4; the step's time
              by CUDA events over 20 steps on device-resident batches, and the trainer
              loop's steps/s with its loader (page-locked batches, each copy enqueued a
              step ahead) over two 50-step epochs of a 1,600-clip speaker, and the
              loader's batches/s alone over a third
 11. train-cli  `python -m speechdrivestemplates_tpu_torch.main --device cuda` for two
              epochs in a subprocess: rc 0, a JSON line naming a checkpoint, and the
              serving command line serves a wav from that checkpoint
 12. pose2pose  the Pose2Pose VAE at full width, B = 32, on phase 10's speaker: one
              step launches no kernel and leaves the banks holding its mu and logvar
              at the batch's clip_index and zeros elsewhere; 30 steps at LR 1e-3 keep
              every loss finite and bring the mean reg_loss of the last 4 below that of
              the first 4; the step's time by CUDA events; its checkpoint
 13. eval     SDT-BP `pipelines.trainer.test` of phase 11's checkpoint on the speaker's
              35 dev clips at TEST.BATCH_SIZE 32 (a batch of 32, then a ragged one of
              3), phase 12's checkpoint as AE_CHECKPOINT: the mel, conv1 and stem
              counters each read the number of eval batches, in_act 21 times that;
              L2_dist within 2% of an
              fp32 all-plain evaluation at the same weights and codes (the codes the
              test drew, read back from its result archives); finite FGD_mu and
              FGD_mu_logvar; the mel kernel and the stem kernels (conv1, then the stem)
              against their plain versions at the ragged batch's shapes (3, 68266)
              and (3, 80, 427); the eval forward's ms per batch of 32
 14. chain-cli  through the command line, two epochs each, in subprocesses:
              `--config_file configs/pose2pose.yaml`, then SDT-BP with its checkpoint as
              AE_CHECKPOINT and TRAIN.VALIDATE True, then `--test_only --checkpoint` of
              that SDT-BP checkpoint (its JSON names the four test metrics), then SDT-VAE
              on the Pose2Pose bank, which its checkpoint holds unchanged
 15. graphed  phase 10's 1,600-clip speaker staged on the card (DATASET.CACHING,
              DEVICE_CACHE on), two 50-step epochs at B = 32 for SDT-BP bf16 and Pose2Pose
              fp32, each at K = 1 (plain Adam), K = 1 with the capturable Adam and K = 8
              (TRAIN.STEPS_PER_DISPATCH: CUDA graphs of 8 steps and of the remainder 2):
              the loop's steps/s; K = 8's 100 loss rows and weights equal K = 1's under
              the same capturable Adam bit for bit (cuDNN deterministic in both); SDT-BP
              executes the mel kernel once per step (8 eager launches, 10 captured, 92
              replayed); then through the command line, K = 8 and the cache on 320 of the
              clips: 4 epochs straight against the straight run's epoch-2 checkpoint
              resumed in a copy of its directory for 2 more (weights and Adam moments
              within rtol 1e-3, atol 1e-5; bit equality reported), and a run sent
              SIGTERM after its first logged step (exit 143, an epoch-(E-1) checkpoint
              with its resume file) that TRAIN.AUTO_RESUME continues to its end
 16. s2g      s2g-GAN (BN generator, no code, the LSGAN discriminator, global poses),
              bf16, full width: (a) three requests (B = 1, 16, 128) through
              build_serving_fn with BN statistics moved by three train-mode forwards:
              the mel counter reads 1, 2, 3, bn_act's 24, 48, 72 (one launch a BN
              layer), conv1's and the stem's stay at 0 (the BN encoder takes no
              InstanceNorm kernel); B = 128 held to an fp32 plain forward (rel L2 <
              0.05, corr > 0.999) and timed; bn_act's launches by layout (8 a request
              channels-last, 16 contiguous); the bn_act kernel at s2g's 24 layer
              shapes at B = 128 in bf16 (the 2-D ones channels-last) against the plain
              path (BN in eval mode, lrelu, cast: within 1 ulp, the share of elements
              bit for bit reported), its ms over the 24 layers beside the plain path's,
              F.batch_norm + F.leaky_relu's and the bound; (b) training at B = 32
              on phase 10's speaker: one step launches mel once, conv1 and the stem
              never; against an fp32 all-plain step at the same weights G_reg_loss and
              D_pose_gan_loss within 2%, D's gradient at cosine >= 0.99 and G's at
              >= 0.75 (a BN generator's bf16 gradient sits near 0.8 in JAX too); 30
              steps at LR 1e-3 finite, G_reg_loss falling; the step's ms; (c) phase 15's
              speaker staged on the card, two 50-step epochs at K = 1 (capturable Adams)
              and K = 8: rows and weights, D's included, equal bit for bit; (d) through
              the command line: 2 epochs with validation (phase 12's checkpoint as
              AE_CHECKPOINT), --test_only of its checkpoint, --resume_from its epoch-1
              checkpoint, and the serving CLI with --config_file on the final .pth
 17. demo     the demo (`main --demo_input`): (a) the mel kernel at (1, 384000) (24 s,
              DATASET.MAX_DEMO_LENGTH) with phase 3's gates, conv1 at (1, 80, 2401) with
              phase 4's, the stem at (1, 82, 2401, 64) with phase 5's, each kernel's ms;
              (b) phase 11's SDT-BP checkpoint, bf16, on clips of 4.27, 10.3 and 24 s
              (64, 154, 360 frames): the dense demo runs each clip at its own length,
              launches mel 1, conv1 1, stem 1, in_act 21 a clip, gives the same poses bit for bit
              with DEMO.LENGTH_BUCKET_S 2.0 (the default, read and ignored) and 0, and is
              held to an fp32 all-plain demo (rel L2 < 0.05, corr > 0.999, poses taken
              about the speaker's mean pose); B1, B3 and B2 are held to their plain
              versions with phases 3-5's gates on each clip's own audio, mel and conv1
              output (widths 427, 1027, 2401), B2's largest distance from the fp32
              result within twice the plain bf16 version's (post-IN values reach 8-19
              on a real clip, where a bf16 ulp is 0.0625-0.125);
              (c) on the 10.3 and 24 s clips the windowed demo (DEMO.WINDOWED, 4 and 11
              windows as one batch) launches each kernel once (in_act 21 times) and is held to its fp32
              all-plain version, and the three kernels to their plain versions on its
              window batch; a streaming session fed 0.5 s chunks through
              build_serving_fn runs each kernel once a window, in_act 21 times (kernels.executions():
              its windows replay one graph) and is held to the
              windowed demo at rel L2 < 0.02 (B = 1 against B = n: cuDNN may round
              otherwise), which a session with an 8-frame halo must fail; ms a clip and
              the real-time factor of every route and length;
              (d) through the command line, SDT-BP on a directory of three wavs (one at
              44.1 kHz, float) with DEMO.MULTIPLE 3 (nine archives); through
              trainer.demo, which the command line calls, s2g from phase 16's checkpoint,
              SDT-VAE from phase 14's, Pose2Pose decoding DEMO.CODE_PATH;
              (e) whether `import cv2` works and ffmpeg is on PATH (facts, not gates)
 18. export   the serving export (the kernels as `torch.ops.sdt.*`): (a) `main --export`
              of phase 11's checkpoint (SDT-BP bf16) at B = 1 and 128 in subprocesses,
              each graph calling sdt.mel, sdt.conv1_in and sdt.stem once and sdt.in_act 21
              times; (b) the B = 128 artifact loaded here: one call launches mel 1, conv1 1,
              stem 1, in_act 21, its poses build_serving_fn's bit for bit, its ms;
              (c) `run_artifact.py` in a subprocess with the B = 1 artifact on phase 8's
              wav: the serving command line's npz of phase 11 (rel L2 < 1e-3, bit
              equality reported); (d) `run_artifact.py --bench 20` at B = 128; (e) phase
              16's s2g checkpoint exported here at B = 16: its graph calls sdt.mel once
              and sdt.bn_act 24 times, one call launches mel once and bn_act 24 times,
              poses held to build_serving_fn's (rel L2 < 1e-3, bit equality reported); (f) export
              and load seconds, artifact bytes; (g) a streaming session off a B = 1
              artifact at the window's length (68,266 samples) launches each kernel once a
              window and is held to the windowed demo of the 24 s clip at phase 17's gate
 19. video    pose videos and TensorBoard images: (a) facts, not gates: matplotlib's and
              cv2's versions, whether ffmpeg is on PATH; (b) `main --demo_input` of phase
              11's checkpoint on the 4.27 and 10.3 s clips with TEST.SAVE_VIDEO True and
              SYS.VIDEO_FORMAT ['mp4', 'img'] (in this process): mel, conv1, stem once a
              clip, in_act 21 times; JAX's videos/*.mp4, *.wav and imgs/*.jpg names; the mp4s decode to 64
              and 154 frames of 720x1280, each within a mean absolute difference of 24
              (over the pixels either frame draws on) of its npz poses redrawn by
              `utils/viz.py`, which a video of the other clip's poses must fail;
              (c) `main --test_only` of phase 11's checkpoint with TEST.SAVE_VIDEO True
              and ['tensorboard', 'mp4']: mel, conv1, stem 2 each, in_act 42, L2_dist equal to phase
              13's bit for bit, test/video/1 and /2 GIFs of 64 frames at 288x512;
              (d) `main` training SDT-BP and Pose2Pose 2 epochs on phase 10's speaker with
              TRAIN.SAVE_VIDEO True (a result step an epoch): the pair videos of JAX's
              names, each decoding to 64 frames; train/clip_code at
              each epoch where matplotlib imports (else the skip line in the log);
              (e) timed, not gated: a 64-frame pair video drawn and saved as mp4 sync and
              async, (c)'s TensorBoard GIFs (from its log), the eval ms per batch of 32
              with videos off and on
 20. parallel ranks over torch.distributed (`parallel_phase`), cuDNN deterministic:
              (a) `main` on SDT-BP fp32, 2 epochs with validation on phase 10's speaker,
              in one process and in a NCCL process group of one (SYS.DISTRIBUTED True):
              mel 8, conv1 4, stem 4 launches each; the checkpoints (per-tensor rel L2)
              and validation metrics (rel) within 1e-6, bit equality reported;
              (b) two ranks sharing the card over gloo (`parallel.dist.spawn`, backend
              'gloo'), global B = 32 (16 a rank): 2 SDT-BP steps in fp32 and in float64
              (a seeded bank: the KL from the first step) and 2 s2g steps in float64,
              equal on both ranks bit for bit, held to one process's steps on the same
              global batches (float64: losses, BN statistics, weights, gradients, 1e-8;
              fp32: the first step's losses and BN statistics, 1e-5, the rest reported),
              mel once a step a rank; the evaluation of phase 11's checkpoint
              (fp32) on the 35 dev clips (16 + 2 a rank, JAX's pad row), equal on both
              ranks and held to one process's evaluation of the same global batches
              (L2 and lip-sync 1e-5, FGD 1e-4); ms a step per rank;
              (c) the sequence-parallel demo (DEMO.SEQUENCE_PARALLEL) of phase 11's
              checkpoint and phase 16's s2g checkpoint, fp32, on phase 17's 24 s clip, at
              one rank (a NCCL group of one) and two (gloo): within 1e-4 of the dense
              forward of the clip padded alike (JAX's gate), the ranks equal bit for
              bit, mel once a rank a clip; ms a clip
 21. loader   the native item loader (`loader_phase`) on phase 10's 1,600-clip speaker:
              (a) the C++ core built with this host's `c++` into a fresh directory (the
              compiler's and zlib's versions, the seconds); (b) gates: every clip's audio
              and poses through the core equal the numpy route's bit for bit, parted
              (SDT-BP) and global (s2g's file), and so do 8 clips re-saved DEFLATE'd and 8
              in data_preprocess/3_1_generate_clips.py's layout (float64, `imgs`); no clip
              rejected; a 63-frame clip rejected (-5), read by numpy and counted; epoch
              1's 50 batches from 8 worker processes equal those of a subprocess with
              SDT_DISABLE_NATIVE=1; materialize()'s arrays equal, 1,600 items through the
              core; (c) times, not gated, min-max over 3 alternated rounds, numpy against
              native items: item ms, the loader's batches/s alone (copied to the card) at
              0 and 8 worker processes, JAX's route (8 threads over the core's items,
              then collate, page-locking, the copy), one B = 32 batch split into item
              work, collate, page-locking and the copy, materialize()'s seconds, a
              worker's move of a batch into shared memory in 1 process and in 8 at
              once, the loader at 2 workers and unpinned with the main thread's wait
              share, the host's CPU count; (d) the inspectors' `npz` and `csv` command
              lines (rc 0, 8 and 128 jpgs)
Then one JSON line with every kernel's error, times, bound and launches (the mel
kernel's count over the serving requests, the train phase's steps, the eval
batches, phase 15's SDT-BP loops, whose CUDA graphs count a launch where it
was captured, not where it was replayed, and phase 16's requests, steps and
loops, phase 17's demo routes, phase 18's main path (one B = 128 artifact
call, one s2g artifact call, the 11 windows streamed off the window
artifact; not its reference, warm-up or timed calls), phase 19's demo,
test and SDT-BP training and phase 20's NCCL run, ranks and demos, every
rank's counted in its own process; conv1's and the stem's over the serving
requests, the eval batches, the demo routes, phase 18, phase 19 and phase
20's evaluations; bn_act's over phase 13's eval batches (the pose encoder's BN
in eval mode), phase 16's requests, phase 18's s2g artifact call and phase
20's evaluations; in_act's over the same SDT-BP routes as conv1's), the card's
name and power limit, a JSON line with the
train step's time, one with phases 12-14's numbers, one with phase 15's, one
with phase 16's, one with phase 17's, one with phase 18's, one with phase
19's, one with phase 20's and one with phase 21's, and last
{"ok": true, "device": {...}}.

Times are CUDA-event means over repeated calls after a warm-up; inputs rotate over
three copies so that each call reads from device memory rather than the 50 MB L2.
"""

from __future__ import annotations

import collections
import glob
import json
import multiprocessing
import os
import shutil
import re
import subprocess
import sys
import time
import wave
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))

# phase 20's gates: (a) a NCCL group of one against one process, per-tensor rel L2 of the
# checkpoint and rel of each validation metric; (b) two ranks against one process on the same
# global batches. In float64 (SDT-BP and s2g), where round-off cannot hide a wrong
# collective: each step's losses (rel), the BN statistics and the parameters after each step
# (rel L2), each gradient's largest error over its largest value. In fp32 (SDT-BP), what the
# pre-step weights alone compute: the first step's losses (rel) and the BN statistics it
# moves (rel L2); its gradients and weights are reported: cuDNN's fp32 weight gradients at
# 16 and 32 rows part by ~1e-3 of a tensor's largest (its algorithms differ by batch size),
# a train-mode BN's are small remainders of cancelling terms, and Adam's first update (~lr *
# sign(g)) carries either into the weights. The evaluation (fp32): L2 and lip-sync (rel) at
# fp32 round-off, FGD looser (its matrix square root amplifies round-off)
A_REL = 1e-6
B_REL = {"fp32": 1e-5, "float64": 1e-8}
B_EVAL_REL = 1e-5
B_FGD_REL = 1e-4
B_RUNS = (("sdt_bp", "fp32"), ("sdt_bp", "float64"), ("s2g", "float64"))
# published dense peaks of one H100 SXM (NVIDIA data sheet): bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- 20. parallel: ranks over torch.distributed, the sequence-parallel demo ---------------

def _rel_l2(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _max_rel(a, b) -> float:
    """The largest absolute difference over the reference's largest value
    (the gate of the JAX package's tests/test_multiprocess.py)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _to_double(state) -> None:
    """A Voice2Pose state's modules and their compute dtype in float64 (the
    parameters stay the objects the optimizers hold; the mel kernel still
    computes in fp32)."""
    import torch

    for module in (state.generator, state.discriminator, state.pose_encoder):
        if module is not None:
            module.double()
            for sub in module.modules():
                if isinstance(getattr(sub, "dtype", None), torch.dtype):
                    sub.dtype = torch.float64
    if isinstance(state.clips_code, torch.nn.Parameter):
        state.clips_code.data = state.clips_code.data.double()


def _parallel_named_grads(state) -> dict:
    import torch

    named = {}
    for prefix, module in (("netG.", state.generator), ("netD_pose.", state.discriminator)):
        if module is not None:
            named.update({prefix + n: p for n, p in module.named_parameters()})
    if isinstance(state.clips_code, torch.nn.Parameter):
        named["clips_code"] = state.clips_code
    return {k: p.grad.detach().clone() for k, p in named.items() if p.grad is not None}


def _parallel_steps(spec, device, global_batches=None) -> dict:
    """Phase 20 (b)'s steps of one preset at full width (fp32, or float64
    with ``spec["double"]``): this rank's
    shard of the first two global batches of epoch 1 under a process group,
    or, with ``global_batches`` (the ranks' rows in rank order), the
    one-process steps on the same global batches. The losses of each step,
    the gradients, statistics and weights after the first, the weights and
    statistics after the second, the launches and a step's ms."""
    import torch

    from speechdrivestemplates_tpu_torch import config as C
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.pipelines import trainer
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                      train_step)

    cfg = C.apply_overrides(getattr(C, spec["preset"])(precision="fp32"), spec["opts"])
    if global_batches is None:
        loader = trainer.train_loader(cfg)
        loader.batch_sampler.set_epoch(1)
        batches = list(loader)[:2]
        num_train = len(loader.dataset)
    else:
        ds = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg)
        batches = [collate([ds[i] for i in idx]) for idx in global_batches]
        num_train = len(ds)
    state = Voice2PoseTrainState(cfg, num_train, device)
    if state.clips_code is not None:  # a seeded bank: the KL is active from the first step
        with torch.no_grad():
            state.clips_code.copy_(torch.randn(state.clips_code.shape,
                                               generator=torch.Generator().manual_seed(5)))
    if spec.get("double"):
        _to_double(state)
    out = {"index": [b["clip_index"].tolist() for b in batches], "losses": []}
    kernels.reset_launch_counts()
    for t, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, _ = train_step(state, b)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3  # the second step's: the first tunes cuDNN
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if t == 0:
            out["grads"] = _parallel_named_grads(state)
            out["state1"] = {k: v.detach().clone() for k, v in state.state_dict().items()}
    out["launches"] = dict(kernels.executions())
    out["state2"] = {k: v.detach().clone() for k, v in state.state_dict().items()}
    del state
    return out


def _parallel_eval(spec, device, global_batches=None) -> dict:
    """Phase 20 (b)'s evaluation of phase 11's checkpoint in fp32 on the 35
    dev clips: this rank's shard at TEST.BATCH_SIZE 32 // ranks, or the
    one-process evaluation of the same global batches."""
    import torch

    from speechdrivestemplates_tpu_torch import config as C
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.pipelines import trainer
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState

    cfg = C.apply_overrides(C.sdt_bp(precision="fp32"), spec["opts"])
    if global_batches is None:
        loader = trainer.eval_loader(cfg)
    else:
        ds = GestureDataset(cfg.DATASET.ROOT_DIR, cfg.DATASET.SPEAKER, cfg, split="val")
        loader = torch.utils.data.DataLoader(ds, batch_sampler=global_batches, collate_fn=collate)
    state = Voice2PoseTrainState(cfg, None, device)
    state.load_pth(spec["ckpt"])
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(state, loader)
    torch.cuda.synchronize()
    return {"metrics": metrics, "index": [b["clip_index"].tolist() for b in loader],
            "launches": dict(kernels.executions()),
            "ms_per_batch": (time.perf_counter() - t0) * 1e3 / len(loader)}


def _parallel_demo(spec, device, dense: bool = False) -> dict:
    """Phase 20 (c): the sequence-parallel demo of each checkpoint (SDT-BP
    and s2g, fp32) on the 24 s clip, its launches and ms; with ``dense``, the
    dense eval forward of the same clip padded as the ranks pad it
    (``spec["ranks"]``), trimmed: the reference."""
    import numpy as np
    import torch

    from speechdrivestemplates_tpu_torch import config as C
    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                      demo_code, demo_step,
                                                                      eval_mode)

    out = {}
    for preset, ckpt in (("sdt_bp", spec["ckpt"]), ("s2g", spec["s2g_ckpt"])):
        cfg = C.apply_overrides(getattr(C, preset)(precision="fp32"), [
            "DEMO.SEQUENCE_PARALLEL", "True", "DEMO.CODE_INDEX", "0", "TEST.SAVE_VIDEO", "False"])
        state = Voice2PoseTrainState(cfg, None, device)
        state.load_pth(ckpt)
        batch = collate([GestureDataset("unused", "oliver", cfg, split="demo",
                                        demo_input=spec["clip"])[0]])
        frames = int(batch["num_frames"][0])
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not dense:
            pred = demo_step(state, batch)["poses_pred_batch"]
        else:
            n = spec["ranks"]
            audio = batch["audio"][0].numpy()
            t_mel = -(-(len(audio) // 160 + 2) // (8 * n)) * (8 * n)
            pad = np.zeros(((t_mel - 1) * 160,), np.float32)
            pad[:len(audio)] = audio
            code = demo_code(state)
            with torch.no_grad(), eval_mode(state.generator):
                p = state.generator(mel_spectrogram(torch.from_numpy(pad[None]).to(device)),
                                    -(-frames // (32 * n)) * (32 * n),
                                    None if code is None else code[None])[:, :frames]
            stat = {k: v.to(device) for k, v in batch["speaker_stat"].items()}
            pred = get_final_results(p, stat["mean"], stat["std"], stat["scale_factor"],
                                     cfg.DATASET.HIERARCHICAL_POSE, cfg.DATASET.NUM_LANDMARKS)
        torch.cuda.synchronize()
        out[preset] = {"poses": pred.detach().cpu(), "frames": frames,
                       "ms": (time.perf_counter() - t0) * 1e3,
                       "launches": dict(kernels.executions())}
        del state
    return out


def _parallel_rank(rank, device, spec) -> dict:
    """One of phase 20's two ranks (gloo, sharing the card): (b)'s steps of
    SDT-BP and s2g and its evaluation, (c)'s sequence-parallel demo."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False  # the parent's fp32 arithmetic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {"steps": {f"{p}_{dt}": _parallel_steps(dict(spec, preset=p, double=dt == "float64"),
                                                  device) for p, dt in B_RUNS},
           "eval": _parallel_eval(spec, device), "demo": _parallel_demo(spec, device)}
    if rank:  # rank 1's weights and gradients travel as a digest
        for s in out["steps"].values():
            s["digest"] = _tensor_digest({**s.pop("state1"), **s.pop("state2"),
                                          **{"g." + k: v for k, v in s.pop("grads").items()}})
    else:
        for s in out["steps"].values():
            s["digest"] = _tensor_digest({**s["state1"], **s["state2"],
                                          **{"g." + k: v for k, v in s["grads"].items()}})
    return out


def _tensor_digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(tensors.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def parallel_phase(ctx) -> dict:
    """Phase 20: (a) ``main`` in one process and in a NCCL group of one, (b)
    two ranks over gloo sharing the card against one process, (c) the
    sequence-parallel demo at one rank (a NCCL group) and two.
    ``ctx`` holds what earlier phases made: phase 10's speaker, phase 11's
    SDT-BP checkpoint, phase 16's s2g checkpoint, phase 17's 24 s clip,
    phase 13's metrics. Adds its launches to ``ctx.report``; returns its JSON
    line."""
    import torch

    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch import main as port_main

    root, ckpt, em, card, work, dev, report = (ctx.root, ctx.ckpt, ctx.em, ctx.card, ctx.work,
                                               ctx.dev, ctx.report)
    from speechdrivestemplates_tpu_torch.parallel import dist as pdist
    from speechdrivestemplates_tpu_torch.utils.weights import read_pth

    t20 = time.perf_counter()
    p20 = collections.Counter()
    pdir = os.path.join(work, "parallel")
    shutil.rmtree(pdir, ignore_errors=True)
    # cuDNN's deterministic algorithms throughout the phase (and in its ranks), so that
    # two runs part by the collectives' arithmetic alone
    torch.backends.cudnn.deterministic = True
    # (a) main on SDT-BP, fp32, 2 epochs with validation on phase 10's speaker: one
    # process, then a process group of one over NCCL (SYS.DISTRIBUTED), whose steps and
    # evaluations take the collectives
    aopts = ["DATASET.ROOT_DIR", root, "SYS.OUTPUT_DIR", pdir, "TRAIN.NUM_EPOCHS", "2",
             "TRAIN.PRECISION", "fp32", "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False"]
    a_runs, a_launch, a_s = {}, {}, {}
    for name, extra in (("one", []), ("nccl1", ["SYS.DISTRIBUTED", "True", "SYS.WORLD_SIZE", "1",
                                                "SYS.MASTER_PORT", str(pdist.free_port())])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        a_runs[name] = port_main.main(["--device", "cuda", "--tag", name, *aopts, *extra])
        torch.cuda.synchronize()
        a_s[name] = time.perf_counter() - t0
        a_launch[name] = dict(kernels.executions())
    check(not pdist.distributed(), "main left a process group behind")
    # 64 clips: 2 steps an epoch, 2 validations of the 35 dev clips (batches 32 and 3)
    want = {"mel": 4 + 4, "conv1": 4, "stem": 4, "in_act": 4 * 21}
    for name in a_runs:
        check({k: a_launch[name].get(k, 0) for k in want} == want and a_runs[name]["steps"] == 4,
              f"(a) {name}: {a_runs[name]['steps']} steps launched {a_launch[name]}, "
              f"expected {want}")
    p20.update(a_launch["nccl1"])
    ck_one, ck_nccl = (read_pth(a_runs[n]["checkpoint"]) for n in ("one", "nccl1"))
    check(ck_one.keys() == ck_nccl.keys(), "(a) the checkpoints' keys differ")
    a_ck_rel = max(_rel_l2(ck_nccl[k], ck_one[k]) for k in ck_one
                   if ck_one[k].is_floating_point() and ck_one[k].norm() > 0)
    a_ck_equal = all(torch.equal(ck_nccl[k], ck_one[k]) for k in ck_one)
    vm_one, vm_nccl = a_runs["one"]["val_metrics"], a_runs["nccl1"]["val_metrics"]
    a_val_rel = {k: abs(vm_nccl[k] - v) / abs(v) for k, v in vm_one.items()}
    check(a_ck_rel <= A_REL and max(a_val_rel.values()) <= A_REL,
          f"(a) NCCL at one rank vs one process: checkpoint rel L2 {a_ck_rel}, validation "
          f"{a_val_rel} (gate {A_REL})")
    print(f"[parallel-a] main SDT-BP fp32 2 epochs: one process {a_s['one']:.1f} s, a NCCL group "
          f"of one {a_s['nccl1']:.1f} s; launches {a_launch['nccl1']} (= one process's); "
          f"checkpoint largest per-tensor rel L2 {a_ck_rel:.3e} (gate {A_REL}), bit for bit "
          f"{a_ck_equal}; validation metrics rel {max(a_val_rel.values()):.3e}, bit for bit "
          f"{vm_one == vm_nccl}; {card}", flush=True)

    # (b) and (c) on two ranks sharing the card over gloo (NCCL takes a card a rank),
    # spawned through the Python entry; (b)'s one-process reference and (c)'s dense
    # reference and NCCL group of one run here after them
    bopts = ["DATASET.ROOT_DIR", root, "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False",
             "TEST.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0"]
    spec = {"opts": bopts, "ckpt": ckpt, "s2g_ckpt": ctx.s2g_ckpt, "clip": ctx.clip, "ranks": 2}
    t0 = time.perf_counter()
    ranks = pdist.spawn(_parallel_rank, 2, (spec,), device="cuda", backend="gloo",
                        timeout_s=600)
    spawn_s = time.perf_counter() - t0
    r0, r1 = ranks
    for r in ranks:
        p20.update(r["eval"]["launches"])
        for part in ("steps", "demo"):
            for v in r[part].values():
                p20.update(v["launches"])
    b_line = {}
    for preset, dtype in B_RUNS:
        run = f"{preset}_{dtype}"
        s0, s1 = r0["steps"][run], r1["steps"][run]
        check(s0["losses"] == s1["losses"] and s0["digest"] == s1["digest"],
              f"(b) {run}: the ranks' losses or weights differ")
        check(all(v.get("mel", 0) == 2 and not v.get("conv1") and not v.get("stem")
                  and not v.get("in_act") for v in (s0["launches"], s1["launches"])),
              f"(b) {run}: 2 steps a rank launched {s0['launches']}, {s1['launches']}")
        one = _parallel_steps(dict(spec, preset=preset, double=dtype == "float64"), dev,
                              [a + b for a, b in zip(s0["index"], s1["index"])])
        loss_rel = [max(abs(s0["losses"][t][k] - v) / max(abs(v), 1e-30)
                        for k, v in one["losses"][t].items()) for t in range(2)]
        stats = [k for k in one["state1"] if k.endswith(("running_mean", "running_var"))]
        stat_rel = [max(_rel_l2(s0[w][k], one[w][k]) for k in stats)
                    for w in ("state1", "state2")]
        params = list(one["grads"])
        param_rel = [_rel_l2(torch.cat([s0[w][k].flatten() for k in params]),
                             torch.cat([one[w][k].flatten() for k in params]))
                     for w in ("state1", "state2")]
        grad_rel = {k: _max_rel(s0["grads"][k], one["grads"][k]) for k in params}
        gate = B_REL[dtype]
        gated = ([loss_rel[0], stat_rel[0]] if dtype == "fp32" else
                 [*loss_rel, *stat_rel, *param_rel, *grad_rel.values()])
        check(max(gated) <= gate,
              f"(b) {run} two ranks vs one process: losses rel {loss_rel}, BN statistics "
              f"rel L2 {stat_rel}, parameters rel L2 {param_rel}, gradients "
              f"{sorted(grad_rel.items(), key=lambda x: -x[1])[:3]} (gate {gate} on "
              f"{'the first step' if dtype == 'fp32' else 'all'})")
        b_line[run] = {"loss_rel_steps": loss_rel, "bn_stats_rel_l2_steps": stat_rel,
                       "params_rel_l2_steps": param_rel,
                       "grad_max_rel": max(grad_rel.values()),
                       "grad_max_rel_bank_bn": max(
                           [v for k, v in grad_rel.items() if ".norm." in k or k == "clips_code"]
                           or [0.0]),
                       "ms_a_step_per_rank": [s0["ms"], s1["ms"]],
                       "ms_a_step_one_process": one["ms"],
                       "launches_per_rank": [s0["launches"], s1["launches"]],
                       "losses": s0["losses"]}
        del one
    e0, e1 = r0["eval"], r1["eval"]
    check(e0["metrics"] == e1["metrics"], f"(b) eval: the ranks' metrics differ: {e0['metrics']} "
                                          f"{e1['metrics']}")
    check([len(b) for b in e0["index"]] == [16, 2] and
          all(v == {"mel": 2, "conv1": 2, "stem": 2, "in_act": 2 * 21}
              for v in ({k: e.get(k, 0) for k in ("mel", "conv1", "stem", "in_act")}
                        for e in (e0["launches"], e1["launches"]))),
          f"(b) eval: batches {[len(b) for b in e0['index']]}, launches {e0['launches']}")
    e_one = _parallel_eval(spec, dev, [a + b for a, b in zip(e0["index"], e1["index"])])
    e_rel = {k: abs(e0["metrics"][k] - v) / abs(v) for k, v in e_one["metrics"].items()}
    check(all(e_rel[k] <= B_EVAL_REL for k in ("L2_dist", "lip_sync_error_n", "G_reg_loss"))
          and max(e_rel.values()) <= B_FGD_REL,
          f"(b) eval, two ranks vs one process on the same global batches: {e_rel}")
    b_line["eval"] = {"metrics": e0["metrics"], "one_process_metrics": e_one["metrics"],
                      "rel": e_rel, "phase13_metrics_bf16": em,
                      "ms_per_batch_per_rank": [e0["ms_per_batch"], e1["ms_per_batch"]]}
    runs = [f"{p}_{dt}" for p, dt in B_RUNS]
    print(f"[parallel-b] two ranks over gloo on one card, global B 32: SDT-BP (fp32, float64) "
          f"and s2g (float64), 2 steps each, equal on both ranks bit for bit; against one "
          f"process on the same global batches (losses and BN statistics after steps 1, 2; "
          f"weights; the largest gradient error): "
          f"{ {r: [b_line[r][k] for k in ('loss_rel_steps', 'bn_stats_rel_l2_steps', 'params_rel_l2_steps', 'grad_max_rel')] for r in runs} } "
          f"(gates {B_REL}; fp32 on step 1's losses and statistics); ms a step per rank "
          f"{ {r: b_line[r]['ms_a_step_per_rank'] for r in runs} } vs one process "
          f"{ {r: b_line[r]['ms_a_step_one_process'] for r in runs} }; ragged eval "
          f"of 35 dev clips (16 + 2 a rank, JAX's pad row): equal on both ranks, vs one process "
          f"rel {max(e_rel.values()):.3e} (gates {B_EVAL_REL}, FGD {B_FGD_REL}); L2_dist {e0['metrics']['L2_dist']:.4f} (phase 13, bf16, "
          f"its own code draws: {em['L2_dist']:.4f}); spawn {spawn_s:.1f} s; {card}", flush=True)

    # (c) the sequence-parallel demo on the 24 s clip: the two ranks' (above), and a NCCL
    # group of one here; each against the dense forward of the clip padded alike
    c_line = {}
    pdist.init_process_group(0, 1, dev, f"tcp://localhost:{pdist.free_port()}", "nccl")
    try:
        c_one = _parallel_demo(dict(spec, ranks=1), dev)
    finally:
        pdist.destroy_process_group()
    for v in c_one.values():
        p20.update(v["launches"])
    for n, got in ((1, {p: [c_one[p]] for p in c_one}),
                   (2, {p: [r0["demo"][p], r1["demo"][p]] for p in r0["demo"]})):
        ref = _parallel_demo(dict(spec, ranks=n), dev, dense=True)
        for preset, outs in got.items():
            check(all(torch.equal(o["poses"], outs[0]["poses"]) for o in outs),
                  f"(c) {preset} at {n} ranks: the ranks' poses differ")
            rel = _max_rel(outs[0]["poses"], ref[preset]["poses"])
            check(outs[0]["poses"].shape == (1, 360, 2, 121) and rel < 1e-4
                  and all(o["launches"] == {"mel": 1} for o in outs),
                  f"(c) {preset} at {n} ranks: {tuple(outs[0]['poses'].shape)}, rel {rel} "
                  f"(gate 1e-4), launches {[o['launches'] for o in outs]}")
            c_line[f"{preset}_ranks{n}"] = {
                "rel_vs_dense": rel, "ms": [o["ms"] for o in outs],
                "dense_ms": ref[preset]["ms"], "launches": [o["launches"] for o in outs]}
    print(f"[parallel-c] sequence-parallel demo, 24 s clip (360 frames), fp32: "
          f"{ {k: (round(v['rel_vs_dense'], 9), [round(m, 2) for m in v['ms']]) for k, v in c_line.items()} } "
          f"(rel vs the dense forward of the clip padded alike, gate 1e-4; ms a clip per rank); "
          f"B1 once a rank a clip; {card}", flush=True)
    torch.backends.cudnn.deterministic = False
    for name, v in p20.items():
        report[name]["launches"] += v
    parallel_line = {"parallel": {"card": card, "a_nccl_world1": {
        "checkpoint_rel_l2": a_ck_rel, "checkpoint_bit_equal": a_ck_equal,
        "val_metrics_rel": a_val_rel, "val_metrics_bit_equal": vm_one == vm_nccl,
        "seconds": a_s, "launches": a_launch["nccl1"]},
        "b_gloo_2ranks": b_line, "c_seq_demo": c_line, "launches": dict(p20),
        "spawn_seconds": spawn_s, "phase_seconds": time.perf_counter() - t20}}
    print(f"[parallel] phase 20 launched {dict(p20)} and took "
          f"{parallel_line['parallel']['phase_seconds']:.1f} s", flush=True)

    return parallel_line


# ---- 21. loader: the native item loader on the card's host --------------------------------

def _batch_digest(batch) -> str:
    """sha256 over a batch's tensors, nested keys flattened."""
    flat = {}
    for k, v in batch.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [("", v)]):
            flat[f"{k}.{kk}"] = vv
    return _tensor_digest(flat)


def loader_epoch_digests(root: str, workers: int = 8) -> list:
    """Phase 21 (b): epoch 1 of the SDT-BP train loader over ``root`` with
    ``workers`` worker processes, a digest a batch. The numpy arm runs it in
    a subprocess with SDT_DISABLE_NATIVE set."""
    from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    loader = train_loader(apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", root,
                                                     "SYS.NUM_WORKERS", str(workers)]))
    loader.batch_sampler.set_epoch(1)
    return [_batch_digest(b) for b in loader]


_SHARE_BARRIER = None


def _share_init(barrier) -> None:
    global _SHARE_BARRIER
    _SHARE_BARRIER = barrier


def _share_memory_ms(job) -> float:
    """Phase 21 (c), in a pool process: ms to move tensors of ``sizes`` bytes
    (one collated batch) into fresh shared memory, as a loader worker does
    before it sends a batch, over ``reps`` batches (``clone`` alone timed and
    subtracted); with ``together``, after the pool's 8 processes meet at a
    barrier, so that all 8 do it at once."""
    import torch

    sizes, reps, together = job
    tensors = [torch.ones(n // 4) for n in sizes]
    if together:
        _SHARE_BARRIER.wait()
    ms = []
    for share in (True, False):
        t0 = time.perf_counter()
        for _ in range(reps):
            for t in tensors:
                t = t.clone()
                if share:
                    t.share_memory_()
        ms.append((time.perf_counter() - t0) / reps * 1e3)
    return ms[0] - ms[1]


def _span(xs) -> list:
    return [min(xs), max(xs)]


def loader_phase(ctx) -> dict:
    """Phase 21: the native item loader on phase 10's 1,600-clip speaker
    (``ctx.root``): (a) its build with this host's compiler; (b) gates: every
    clip's item through the core = the numpy route's, parted and global, in
    two more layouts, the rejections, one epoch's batches of 8 worker
    processes = a numpy run's; (c) times, not gated: items, the loader's
    batches/s by item route and worker count, JAX's thread route, a batch's
    split, ``materialize()``, and a worker's shared-memory hand-off alone in
    1 process and in 8 at once (a spawned pool: a script that calls this
    runs its own work under ``if __name__ == "__main__"``); (d) the
    inspectors' command lines. Returns its JSON line."""
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from speechdrivestemplates_tpu_torch.config import apply_overrides, load_config, sdt_bp
    from speechdrivestemplates_tpu_torch.datasets import gesture_dataset as gd
    from speechdrivestemplates_tpu_torch.datasets import native_loader as nl
    from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_loader

    t21 = time.perf_counter()
    root, dev = ctx.root, ctx.dev
    ldir = os.path.join(ctx.work, "loader")
    shutil.rmtree(ldir, ignore_errors=True)
    os.makedirs(ldir)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("SDT_DISABLE_NATIVE", None)

    def numpy_route(on: bool) -> None:
        if on:
            os.environ["SDT_DISABLE_NATIVE"] = "1"
        else:
            os.environ.pop("SDT_DISABLE_NATIVE", None)

    numpy_route(False)

    # (a) the core built with this host's compiler into a fresh directory
    cxx = subprocess.run(["c++", "--version"], capture_output=True, text=True, timeout=60)
    zh = subprocess.run(["c++", "-E", "-dM", "-x", "c++", "-"], input="#include <zlib.h>\n",
                        capture_output=True, text=True, timeout=60)
    zlib_version = re.search(r'#define ZLIB_VERSION "([^"]+)"', zh.stdout)
    check(cxx.returncode == 0 and zlib_version is not None,
          f"the host's c++ or zlib.h: {cxx.stderr}{zh.stderr[-2000:]}")
    build_s = nl.ensure_built(os.path.join(ldir, "build"))
    check(build_s is not None and nl.library(os.path.join(ldir, "build"))
          .sdt_dataio_abi_version() == 1, "the core did not build into a fresh directory")
    check(nl.native_available(), "the dataset's core (build/libsdt_dataio.so) is not loaded")
    build = {"compiler": cxx.stdout.splitlines()[0], "zlib": zlib_version.group(1),
             "build_s": build_s, "flags": nl.CXX_FLAGS}
    print(f"[loader] (a) {build}", flush=True)

    # (b) every clip, parted (SDT-BP) and global (s2g's file): the core = numpy
    nl.REJECTED.clear()
    parted_cfg = apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", root, "SYS.NUM_WORKERS", "0"])
    global_cfg = load_config(os.path.join(ROOT, "configs", "voice2pose_s2g.yaml"),
                             ["DATASET.ROOT_DIR", root, "DATASET.SPEAKER", "oliver",
                              "SYS.NUM_WORKERS", "0"])
    check(parted_cfg.DATASET.HIERARCHICAL_POSE and not global_cfg.DATASET.HIERARCHICAL_POSE,
          "phase 21's configs: parted SDT-BP and global s2g")
    ds = gd.GestureDataset(root, "oliver", parted_cfg)
    T, L = ds.num_frames, ds.audio_length

    def same(path, parted):
        st = get_speaker_stat("oliver", 121, parted)
        got = nl.load_clip_native(path, T, parted, st["mean"], st["std"], L)
        poses, audio = gd.load_clip_numpy(path, T, parted, st["mean"], st["std"], L)
        return (got is not None and np.array_equal(got[0], poses)
                and got[2].tobytes() == audio.tobytes())

    paths = [os.path.join(root, "oliver", c["pose_fn"]) for c in ds.clips]
    check(len(paths) >= 64, f"phase 10's speaker has {len(paths)} train clips")
    t0 = time.perf_counter()
    for parted in (True, False):
        bad = [p for p in paths if not same(p, parted)]
        check(not bad, f"{len(bad)} clips differ between the core and numpy "
                       f"({'parted' if parted else 'global'}), e.g. {bad[:3]}")
    every_s = time.perf_counter() - t0
    # the same 8 clips re-saved DEFLATE'd, and in 3_1_generate_clips.py's layout
    layouts = {"compressed": [], "float64_imgs": []}
    for i, p in enumerate(paths[:8]):
        with np.load(p) as z:
            pose, audio = z["pose"], z["audio"]
        q = os.path.join(ldir, f"deflate_{i}.npz")
        np.savez_compressed(q, pose=pose, audio=audio)
        layouts["compressed"].append(q)
        q = os.path.join(ldir, f"f64_{i}.npz")
        np.savez(q, pose=pose.astype(np.float64) + 1 / 3, audio=audio.astype(np.float64) / 3,
                 imgs=np.array([f"frames/{i}_{t:06d}.jpg" for t in range(len(pose))]))
        layouts["float64_imgs"].append(q)
    for name, qs in layouts.items():
        for parted in (True, False):
            check(all(same(q, parted) for q in qs), f"{name} clips: the core != numpy")
    check(not nl.REJECTED, f"the core rejected clips of phase 21's layouts: {dict(nl.REJECTED)}")
    # a 63-frame clip: rejected (-5), read by numpy, counted
    short_root = os.path.join(ldir, "short")
    make_synthetic_speaker(short_root, "oliver", num_train=1, num_dev=0)
    sp = os.path.join(short_root, "oliver", "clip_0000.npz")
    with np.load(sp) as z:
        pose, audio = z["pose"], z["audio"]
    np.savez(sp, pose=pose[:T - 1], audio=audio)
    item = gd.GestureDataset(short_root, "oliver", apply_overrides(
        sdt_bp(), ["DATASET.ROOT_DIR", short_root]))[0]
    st = get_speaker_stat("oliver", 121, True)
    check(dict(nl.REJECTED) == {-5: 1} and item["poses"].shape == (T - 1, 2, 121)
          and np.array_equal(item["poses"], gd.load_clip_numpy(sp, T, True, st["mean"],
                                                                st["std"], L)[0]),
          f"the 63-frame clip: REJECTED {dict(nl.REJECTED)}, poses {item['poses'].shape}")
    nl.REJECTED.clear()
    # one epoch's batches, 8 worker processes: the core here, numpy in a subprocess
    t0 = time.perf_counter()
    native_digests = loader_epoch_digests(root)
    r = subprocess.run([sys.executable, "-c",
                        "import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                        "print(json.dumps(chip_smoke.loader_epoch_digests(sys.argv[2])))",
                        ROOT, root], cwd=ROOT, env=dict(env, SDT_DISABLE_NATIVE="1"),
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"the numpy epoch's subprocess rc {r.returncode}:\n{r.stderr}")
    numpy_digests = json.loads(r.stdout.strip().splitlines()[-1])
    check(len(native_digests) == len(paths) // 32 and native_digests == numpy_digests,
          f"an epoch's batches: {len(native_digests)} with the core, {len(numpy_digests)} "
          f"numpy, {sum(a != b for a, b in zip(native_digests, numpy_digests))} differ")
    epoch_gate_s = time.perf_counter() - t0
    print(f"[loader] (b) {len(paths)} clips parted and global, 8 DEFLATE'd and 8 float64 + "
          f"imgs clips: the core = numpy bit for bit ({every_s:.1f} s); REJECTED empty; a "
          f"63-frame clip rejected -5, read by numpy, counted; epoch 1's "
          f"{len(native_digests)} batches with 8 workers = SDT_DISABLE_NATIVE=1's "
          f"({epoch_gate_s:.1f} s)", flush=True)

    # (c) times, not gated: alternated rounds of every arm in this process
    def to_dev(x):
        return {k: to_dev(v) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    schedule = train_loader(parted_cfg).batch_sampler
    schedule.set_epoch(1)
    batches = schedule.index_batches()

    def item_ms():
        n = min(200, len(ds))
        t0 = time.perf_counter()
        for i in range(n):
            ds[i]
        return (time.perf_counter() - t0) / n * 1e3

    def loader_rate(loader, epoch, waits=None):
        """Batches/s of an epoch, each copied to the card; appends to
        ``waits`` the share of the time the main thread waited for batches."""
        loader.batch_sampler.set_epoch(epoch)
        torch.cuda.synchronize()
        t0, n, wait = time.perf_counter(), 0, 0.0
        it = iter(loader)
        while True:
            t1 = time.perf_counter()
            b = next(it, None)
            wait += time.perf_counter() - t1
            if b is None:
                break
            to_dev(b)
            n += 1
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if waits is not None:
            waits.append(wait / took)
        return n / took

    pool = ThreadPoolExecutor(8)

    def thread_rate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for idx in batches:
            to_dev(gd.to_torch(gd.stack(list(pool.map(ds.__getitem__, idx))), pin=True))
        torch.cuda.synchronize()
        return len(batches) / (time.perf_counter() - t0)

    def page_lock(x):
        return ({k: page_lock(v) for k, v in x.items()} if isinstance(x, dict)
                else x.pin_memory())

    def split_ms(nb=10):
        """A batch's ms in the loader's four steps, done one after another."""
        parts = collections.Counter()
        for idx in batches[:nb]:
            t = [time.perf_counter()]
            items = [ds[int(i)] for i in idx]
            t.append(time.perf_counter())
            host = gd.collate(items)
            t.append(time.perf_counter())
            pinned = page_lock(host)
            t.append(time.perf_counter())
            to_dev(pinned)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for k, a, b in zip(("items", "collate", "pin", "copy"), t, t[1:]):
                parts[k] += (b - a) / nb * 1e3
        return dict(parts)

    # the hand-off alone: each loader worker moves its collated batch into shared
    # memory before it sends it; timed in 1 process, and in 8 at once
    sizes = [v.nbytes for x in gd.collate([ds[int(i)] for i in batches[0]]).values()
             for v in (x.values() if isinstance(x, dict) else [x])]
    ctx8 = multiprocessing.get_context("spawn")
    barrier = ctx8.Barrier(8)
    share_pool = ctx8.Pool(8, initializer=_share_init, initargs=(barrier,))
    share_pool.map(_share_memory_ms, [(sizes, 1, True)] * 8, chunksize=1)  # warm

    def share_ms():
        one = share_pool.apply(_share_memory_ms, ((sizes, 5, False),))
        eight = share_pool.map(_share_memory_ms, [(sizes, 5, True)] * 8, chunksize=1)
        return one, sum(eight) / len(eight)

    def workers_loader(workers, numpy_items, pin=True):
        numpy_route(numpy_items)  # read by the workers, forked at the first epoch
        lo = train_loader(apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", root,
                                                     "SYS.NUM_WORKERS", str(workers)]), dev)
        if not pin:  # the same loader without page-locking: the main thread receives
            lo = torch.utils.data.DataLoader(
                lo.dataset, batch_sampler=lo.batch_sampler, collate_fn=gd.collate,
                num_workers=workers, persistent_workers=True)
        loader_rate(lo, 0)  # starts the workers: a warm pool from here on
        numpy_route(False)
        return lo

    # the loader's worker processes, warm: numpy and native items at 8 (the
    # default), and, to find what limits it, native items at 2 workers and at 8
    # without page-locking (whose receiving runs in the main thread)
    pools = {"8_workers_numpy": workers_loader(8, True),
             "8_workers_native": workers_loader(8, False),
             "2_workers_native": workers_loader(2, False),
             "8_workers_native_unpinned": workers_loader(8, False, pin=False)}
    lo0 = train_loader(parted_cfg, dev)
    counted = collections.Counter()
    native_fn = nl.load_clip_native

    def counting(*a):
        got = native_fn(*a)
        counted["items"] += got is not None
        return got

    times = collections.defaultdict(list)
    split = {"numpy": [], "native": []}
    soa_equal = None
    for rnd in range(3):
        for route in ("numpy", "native"):
            numpy_route(route == "numpy")
            times[f"item_ms_{route}"].append(item_ms())
            times[f"batches_per_s_0_workers_{route}"].append(loader_rate(lo0, rnd + 1))
            for name, lo in pools.items():
                if name.split("_")[2] == route:
                    times[f"batches_per_s_{name}"].append(loader_rate(
                        lo, rnd + 1, times[f"main_wait_share_{name}"]))
            split[route].append(split_ms())
            cds = gd.GestureDataset(root, "oliver", apply_overrides(
                sdt_bp(), ["DATASET.ROOT_DIR", root, "DATASET.CACHING", "True"]))
            nl.load_clip_native = counting
            counted.clear()
            t0 = time.perf_counter()
            soa = cds.materialize()
            times[f"materialize_s_{route}"].append(time.perf_counter() - t0)
            nl.load_clip_native = native_fn
            check(counted["items"] == (0 if route == "numpy" else len(paths)),
                  f"materialize() with {route} items: {counted['items']} through the core")
            if rnd == 0:
                if route == "numpy":
                    soa_numpy = soa
                else:
                    soa_equal = all(soa[k].tobytes() == soa_numpy[k].tobytes()
                                    for k in ("audio", "poses", "clip_index"))
                    check(soa_equal, "materialize(): the core's SoA arrays != numpy's")
                    del soa_numpy
            del cds, soa
        numpy_route(False)
        times["batches_per_s_8_threads_native"].append(thread_rate())
        one, eight = share_ms()
        times["share_memory_ms_1_process"].append(one)
        times["share_memory_ms_8_processes_at_once"].append(eight)
    pool.shutdown()
    share_pool.close()
    share_pool.join()
    check(not nl.REJECTED, f"the core rejected clips of phase 10's speaker: {dict(nl.REJECTED)}")
    del pools, lo0
    batch_bytes = sum(sizes)
    split_span = {route: {k: _span([s[k] for s in rounds]) for k in rounds[0]}
                  for route, rounds in split.items()}

    # (d) the inspectors' command lines
    ndir, cdir = os.path.join(ldir, "viz_npz"), os.path.join(ldir, "viz_csv")
    for args, out_dir, want in (
            (["npz", paths[0], "-o", ndir, "--max-frames", "8"], ndir, 8),
            (["csv", root, "oliver", "--max-clips", "2", "-o", cdir], cdir, 2 * T)):
        r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.utils.viz",
                            *args], cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=300)
        jpgs = glob.glob(os.path.join(out_dir, "**", "*.jpg"), recursive=True)
        check(r.returncode == 0 and len(jpgs) == want,
              f"viz {args[0]}: rc {r.returncode}, {len(jpgs)} jpgs (want {want}):\n{r.stderr}")

    line = {"card": ctx.card, "cpu_count": os.cpu_count(),
            "sched_affinity": len(os.sched_getaffinity(0)), **build,
            "clips": len(paths), "batch": len(batches[0]), "batch_bytes": batch_bytes,
            "every_clip_equal": True, "epoch_batches_equal": True,
            "materialize_soa_equal": soa_equal, "rounds": 3,
            **{k: _span(v) for k, v in times.items()},
            "batch_split_ms": split_span,
            "phase10_loop_steps_per_s_with_loader": ctx.loop_rates,  # epochs 1, 2
            "phase10_loader_alone_batches_per_s": ctx.loader_rate,
            "seconds": time.perf_counter() - t21}
    print(f"[loader] (c) min-max over 3 alternated rounds: "
          f"{ {k: line[k] for k in times} }; one B = {len(batches[0])} batch "
          f"({batch_bytes / 1e6:.2f} MB), ms: {split_span}; (d) viz npz 8 jpgs, csv "
          f"{2 * T} jpgs; phase 21 took {line['seconds']:.1f} s", flush=True)
    return {"loader": line}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops import shift_probe as SP
    from speechdrivestemplates_tpu_torch.ops import stem as S
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn
    from speechdrivestemplates_tpu_torch.utils.timing import card as card_line
    from speechdrivestemplates_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    # reference arithmetic in full fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)

    # ---- 1. device ---------------------------------------------------------------
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}", flush=True)

    # ---- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all()
    for name in kernels.SIGNATURES:
        kernels.library(name)
    print(f"[build] {sorted(kernels.SIGNATURES)} in {time.perf_counter() - t0:.2f} s "
          f"(compiled now: {built})", flush=True)

    def dev_randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    report = {}
    # eval-mode BN + lrelu + cast: launched from phase 13 on, checked and timed in phase 16
    report["bn_act"] = dict(
        name="bn_act", route="cuda", source="speechdrivestemplates_tpu_torch/csrc/bn_act.cu",
        replaces="none: XLA fuses eval BN, lrelu and the cast in the JAX package", launches=0)
    # eval-mode IN + lrelu + cast after the stem: launched, checked and timed from phase 7 on
    report["in_act"] = dict(
        name="in_act", route="cuda", source="speechdrivestemplates_tpu_torch/csrc/in_act.cu",
        replaces="none: XLA fuses IN, lrelu and the cast in the JAX package", launches=0)

    # ---- 3. mel kernel -----------------------------------------------------------
    def check_mel(audio, what):
        """B1 against its plain version on ``audio`` and on a copy whose second
        half is 60 dB quieter. The kernel's three-pass bf16 split keeps ~2^-16
        relative: the gate of tests/test_mel_pallas.py. The quiet half's mel
        values sit far below atol, so the frames whose window (samples
        160 t - 200 .. 160 t + 199) lies wholly inside it are also held
        relatively, on the bins above 1e-3 of their largest. Returns the max abs
        error, the quiet frames' max rel error and their first frame."""
        b, n = audio.shape
        wide = audio.clone()
        wide[:, n // 2:] *= 1e-3
        t_quiet = -(-(n // 2 + 200) // 160)
        err = 0.0
        for name, a in (("normal", audio), ("60 dB", wide)):
            k = M.mel_spectrogram_kernel(a)
            p = M.mel_spectrogram_plain(a)
            torch.cuda.synchronize()
            check(k.shape == p.shape == (b, 80, n // 160 + 1), f"mel shape {tuple(k.shape)}")
            e = (k - p).abs().max().item()
            check(torch.allclose(k, p, rtol=1e-3, atol=1e-4),
                  f"mel kernel vs plain ({what}, {name} input): max abs err {e}")
            err = max(err, e)
        q = p[..., t_quiet:]
        sel = q > 1e-3 * q.max()
        quiet_rel = ((k[..., t_quiet:] - q).abs()[sel] / q[sel]).max().item()
        check(quiet_rel <= 1e-3,
              f"mel kernel vs plain on the quiet half ({what}): max rel err {quiet_rel}")
        return err, quiet_rel, t_quiet

    B, L = 128, 68267
    T = L // 160 + 1
    audios = [dev_randn(B, L, scale=0.1) for _ in range(3)]
    mel_err, quiet_rel, t_quiet = check_mel(audios[0], f"({B}, {L})")
    fb = torch.from_numpy(M._mel_filterbank_np(16000, 512, 80, 55.0, 7500.0)).to(dev)
    hann = torch.hann_window(400, periodic=True, device=dev)

    def mel_library(a):
        spec = torch.stft(a, 512, 160, 400, hann, center=True, pad_mode="reflect",
                          return_complex=True)
        return fb.T @ (spec.real ** 2 + spec.imag ** 2)

    check(torch.allclose(mel_library(audios[0]), M.mel_spectrogram_plain(audios[0]),
                         rtol=1e-3, atol=1e-4),
          "torch.stft yardstick disagrees with the plain mel")
    # the DFT (400 taps x 512 columns) and the mel projection (256 x 80) on the
    # tensor cores, three bf16 passes each
    n_frames = B * T
    mel_b, mel_by = bound_ms(4.0 * (B * L + B * 80 * T),
                             3 * 2.0 * n_frames * (400 * 512 + 256 * 80), "bf16")
    report["mel"] = dict(
        name="mel_stft_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/mel.cu",
        replaces="speechdrivestemplates_tpu/ops/mel_pallas.py:123",
        max_abs_err=mel_err,
        ms=cuda_ms(M.mel_spectrogram_kernel, [(a,) for a in audios]),
        plain_ms=cuda_ms(M.mel_spectrogram_plain, [(a,) for a in audios]),
        bound_ms=mel_b, bound_by=mel_by,
        library_ms=cuda_ms(mel_library, [(a,) for a in audios]))
    print(f"[mel] (128, 68267) normal and 60 dB inputs: max abs err {mel_err:.3e} "
          f"(rtol 1e-3, atol 1e-4); quiet half of the 60 dB input (frames {t_quiet}-{T - 1}): "
          f"max rel err {quiet_rel:.3e} (rtol 1e-3); "
          f"kernel {report['mel']['ms']:.4f} ms, plain {report['mel']['plain_ms']:.4f} ms, "
          f"torch.stft {report['mel']['library_ms']:.4f} ms, bound {mel_b:.4f} ms "
          f"({mel_by})", flush=True)

    # ---- 4. conv1 kernel ---------------------------------------------------------
    bf = torch.bfloat16
    W1 = T
    mels = [dev_randn(B, 80, W1) for _ in range(3)]
    w1, w2, w3 = dev_randn(64, 1, 3, 3, scale=0.2), dev_randn(64, 64, 4, 4, scale=0.05), \
        dev_randn(128, 64, 3, 3, scale=0.05)
    ref1 = C1.conv1_in_plain(mels[0], w1, 0.2, torch.float32)
    k1 = C1.conv1_in_kernel(mels[0], w1, 0.2, torch.float32)
    k1b = C1.conv1_in_kernel(mels[0], w1, 0.2, bf)
    torch.cuda.synchronize()
    check(k1.shape == ref1.shape == k1b.shape == (B, C1.ROWS, W1, 64),
          f"conv1 shape {tuple(k1.shape)}")
    conv1_err = (k1 - ref1).abs().max().item()
    # fp32 FMAs of the same operands on both sides; the statistics are summed in
    # another order: the gate of tests/test_conv1_pallas.py
    check(torch.allclose(k1, ref1, rtol=2e-5, atol=2e-5),
          f"conv1 fp32 kernel vs plain: max abs err {conv1_err}")
    for t in (k1, k1b):
        check(not t[:, 0].any() and not t[:, -1].any(), "conv1 rows 0 and 81 are not zero")
    conv1_rel16 = ((k1b.float() - ref1).abs().mean() / ref1.abs().mean()).item()
    check(conv1_rel16 < 2e-2, f"conv1 bf16 kernel vs fp32 plain: mean rel err {conv1_rel16}")
    # a mel at a large constant offset, where fp32 moments E[y^2] - E[y]^2 would
    # lose digits: the kernel's fp64 Gram statistics hold the same fp32 gate
    offset_mel = mels[0] + 100.0
    ref1 = C1.conv1_in_plain(offset_mel, w1, 0.2, torch.float32)
    k1 = C1.conv1_in_kernel(offset_mel, w1, 0.2, torch.float32)
    torch.cuda.synchronize()
    offset_err = (k1 - ref1).abs().max().item()
    check(torch.allclose(k1, ref1, rtol=2e-5, atol=2e-5),
          f"conv1 fp32 kernel vs plain on the offset mel: max abs err {offset_err}")
    check(not k1[:, 0].any() and not k1[:, -1].any(), "conv1 rows 0 and 81 are not zero")
    conv1_err = max(conv1_err, offset_err)
    del ref1, k1, k1b, offset_mel

    def conv1_library(mel):
        x = F.conv2d(mel[:, None].to(bf), w1.to(bf), padding=1)
        return F.leaky_relu(F.instance_norm(x), 0.2)

    conv1_b, conv1_by = bound_ms(4.0 * B * 80 * W1 + 4.0 * w1.numel() + 2.0 * B * C1.ROWS * W1 * 64,
                                 2.0 * B * 80 * W1 * 64 * 9, "fp32")
    conv1_args = [(m, w1, 0.2, bf) for m in mels]
    report["conv1"] = dict(
        name="conv1_in_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/conv1.cu",
        replaces="probes/conv1_pallas.py:117",
        max_abs_err=conv1_err,
        ms=cuda_ms(C1.conv1_in_kernel, conv1_args),
        plain_ms=cuda_ms(C1.conv1_in_plain, conv1_args, 5),
        bound_ms=conv1_b, bound_by=conv1_by,
        library_ms=cuda_ms(conv1_library, [(m,) for m in mels]))
    print(f"[conv1] (128, 80, {W1}) fp32 max abs err {conv1_err:.3e} (rtol 2e-5, atol 2e-5) "
          f"over a normal mel and one offset by 100 ({offset_err:.3e} there); "
          f"rows 0 and 81 zero; bf16 mean rel err {conv1_rel16:.3e} (< 2e-2); bf16 kernel "
          f"{report['conv1']['ms']:.4f} ms, plain {report['conv1']['plain_ms']:.4f} ms, cuDNN "
          f"conv1+IN+lrelu {report['conv1']['library_ms']:.4f} ms, bound {conv1_b:.4f} ms "
          f"({conv1_by})", flush=True)

    # ---- 5. stem: conv1 kernel + stem kernel ---------------------------------------
    H2, W2 = S.stem_dims(W1)
    ref32 = S.stem_plain(mels[0], w1, w2, w3, 0.2, torch.float32)
    k32 = S.stem_kernel(mels[0], w1, w2, w3, 0.2, torch.float32)
    torch.cuda.synchronize()
    check(k32.shape == ref32.shape == (B, H2, W2, 128), f"stem shape {tuple(k32.shape)}")
    whole_err = (k32 - ref32).abs().max().item()
    # both sides accumulate fp32 products of the same operands (no TF32): they differ
    # by summation order only, ~1e-6 relative on O(1) post-norm values
    check(torch.allclose(k32, ref32, rtol=2e-4, atol=2e-5),
          f"stem fp32 kernels vs plain: max abs err {whole_err}")
    k16 = S.stem_kernel(mels[0], w1, w2, w3, 0.2, bf).float()
    err16 = (k16 - ref32).abs().flatten()
    q99 = torch.quantile(err16[:: max(1, err16.numel() // 4_000_000)], 0.99).item()
    check(q99 < 0.05 and err16.mean().item() < 0.02,
          f"stem bf16 kernels vs fp32 plain: p99 {q99}, mean {err16.mean().item()}")
    del ref32, k32, k16, err16
    # the stem kernel alone, on one conv1 activation: first its fp32 path (the
    # CUDA-core kernel, kept for the tight gate), then the served bf16 path
    # (wgmma, bf16 y2 and y3) against the plain tail in bf16
    y1 = C1.conv1_in_plain(mels[0], w1, 0.2, torch.float32)
    t32 = S.stem_tail_kernel(y1, w2, w3, 0.2, torch.float32)
    tref = S.stem_tail_plain(y1, w2, w3, 0.2, torch.float32)
    torch.cuda.synchronize()
    fp32_err = (t32 - tref).abs().max().item()
    check(torch.allclose(t32, tref, rtol=2e-4, atol=2e-5),
          f"stem kernel fp32 path vs plain on one activation: max abs err {fp32_err}")
    del y1, t32, tref
    y1s = [C1.conv1_in_kernel(m, w1, 0.2, bf) for m in mels]
    t16 = S.stem_tail_kernel(y1s[0], w2, w3, 0.2, bf)
    tref = S.stem_tail_plain(y1s[0], w2, w3, 0.2, bf)
    torch.cuda.synchronize()
    check(t16.shape == tref.shape == (B, H2, W2, 128) and t16.dtype == bf,
          f"stem kernel bf16 shape {tuple(t16.shape)} {t16.dtype}")
    e16 = (t16.float() - tref.float()).abs().flatten()
    stem_err = e16.max().item()
    tail_q99 = torch.quantile(e16[:: max(1, e16.numel() // 4_000_000)], 0.99).item()
    # bf16 roundings of y2, y3 and the output in another order: a few bf16 ulps of
    # the O(1) post-norm values at most (one ulp is 2^-5 at 4)
    check(tail_q99 < 0.05 and e16.mean().item() < 0.02 and stem_err < 0.1,
          f"stem kernel bf16 vs plain bf16 on one activation: p99 {tail_q99}, "
          f"mean {e16.mean().item()}, max abs err {stem_err}")
    del t16, tref, e16
    w2b, w3b = w2.to(bf), w3.to(bf)

    def stem_library(y1):
        x = F.conv2d(y1.permute(0, 3, 1, 2), w2b, stride=2, padding=(0, 1))
        x = F.leaky_relu(F.instance_norm(x), 0.2)
        x = F.conv2d(x, w3b, padding=1)
        return F.leaky_relu(F.instance_norm(x), 0.2)

    # the stem kernel's work: conv2 + conv3 on the 80 data rows of the activation
    stem_flops = 2.0 * B * H2 * W2 * (64 * 64 * 16 + 128 * 64 * 9)
    stem_bytes = 2.0 * B * 80 * W1 * 64 + 2.0 * (w2.numel() + w3.numel()) \
        + 2.0 * B * H2 * W2 * 128
    stem_b, stem_by = bound_ms(stem_bytes, stem_flops, "bf16")
    tail_args = [(y, w2, w3, 0.2, bf) for y in y1s]
    report["stem"] = dict(
        name="audio_encoder_stem_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/stem.cu",
        replaces="probes/stem_pallas.py:192",
        max_abs_err=stem_err,
        ms=cuda_ms(S.stem_tail_kernel, tail_args, 10),
        plain_ms=cuda_ms(S.stem_tail_plain, tail_args, 10),
        bound_ms=stem_b, bound_by=stem_by,
        library_ms=cuda_ms(stem_library, [(y,) for y in y1s], 10))
    whole_ms = cuda_ms(S.stem_kernel, [(m, w1, w2, w3, 0.2, bf) for m in mels], 10)
    print(f"[stem] (128, 80, {W1}) conv1+stem kernels fp32 max abs err {whole_err:.3e} "
          f"(rtol 2e-4, atol 2e-5), bf16 vs fp32 p99 {q99:.4f} (< 0.05); stem kernel alone: "
          f"fp32 path (CUDA cores) max abs err {fp32_err:.3e} (rtol 2e-4, atol 2e-5), bf16 "
          f"path (wgmma) vs plain bf16 max abs err {stem_err:.3e} (< 0.1), p99 {tail_q99:.4f} "
          f"(< 0.05); bf16 stem kernel {report['stem']['ms']:.4f} ms, "
          f"plain {report['stem']['plain_ms']:.4f} ms, cuDNN {report['stem']['library_ms']:.4f} "
          f"ms, bound {stem_b:.4f} ms ({stem_by}); whole stem (conv1 + stem kernels) "
          f"{whole_ms:.4f} ms", flush=True)
    del mels, audios, y1s

    # ---- 6. shift-probe kernel ------------------------------------------------------
    # C = 128 (a 2-CTA cluster) for the kernels line, and C = 64 (one CTA)
    NP, MP = 128, 4480
    MP_out = MP - 2 * 224
    shift_ms, shift_err = {}, 0.0
    for CP in (64, 128):
        xs = [dev_randn(NP, MP, CP, scale=0.1).to(bf) for _ in range(3)]
        wsh = dev_randn(9, CP, CP, scale=0.05).to(bf)
        for mode in SP.MODES:
            ks = SP.shift_taps_kernel(xs[0], wsh, MP_out, mode)
            ps = SP.shift_taps_plain(xs[0], wsh, MP_out, mode)
            torch.cuda.synchronize()
            check(ks.shape == ps.shape == (NP, MP_out, CP) and ks.dtype == bf,
                  f"shift C={CP} {mode} shape {tuple(ks.shape)} {ks.dtype}")
            err = (ks.float() - ps.float()).abs().max().item()
            # the same fp32 sums in another order, each cast to bf16: one rounding apart
            check(torch.allclose(ks.float(), ps.float(), rtol=1e-2, atol=1e-3),
                  f"shift C={CP} {mode} kernel vs plain: max abs err {err}")
            shift_err = max(shift_err, err)
            shift_ms[(CP, mode)] = cuda_ms(SP.shift_taps_kernel,
                                           [(x, wsh, MP_out, mode) for x in xs])
            del ks, ps
    CP = 128  # xs and wsh are C = 128's now
    w_conv = wsh.permute(2, 1, 0).contiguous()

    def shift_library(x):
        return F.conv1d(x[:, :MP_out + 8].transpose(1, 2), w_conv)

    shift_b, shift_by = bound_ms(2.0 * (NP * MP * CP + wsh.numel() + NP * MP_out * CP),
                                 2.0 * NP * MP_out * CP * CP * 9, "bf16")
    report["shift_probe"] = dict(
        name="shift_taps_probe", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/shift_probe.cu",
        replaces="bench_profile.py:523",
        max_abs_err=shift_err,
        ms=shift_ms[(128, "subtile")],
        plain_ms=cuda_ms(SP.shift_taps_plain, [(x, wsh, MP_out, "subtile") for x in xs], 5),
        bound_ms=shift_b, bound_by=shift_by,
        library_ms=cuda_ms(shift_library, [(x,) for x in xs]))
    print(f"[shift] ({NP}, {MP}, C) x (9, C, C), C = 64 and 128, aligned and subtile: max abs "
          f"err {shift_err:.3e} (rtol 1e-2, atol 1e-3); kernel C=128 aligned "
          f"{shift_ms[(128, 'aligned')]:.4f} ms, subtile {shift_ms[(128, 'subtile')]:.4f} ms; "
          f"C=64 aligned {shift_ms[(64, 'aligned')]:.4f} ms, subtile "
          f"{shift_ms[(64, 'subtile')]:.4f} ms; C=128 plain "
          f"{report['shift_probe']['plain_ms']:.4f} ms, cuDNN conv1d "
          f"{report['shift_probe']['library_ms']:.4f} ms, bound {shift_b:.4f} ms ({shift_by})",
          flush=True)
    del xs

    # ---- 7. serving --------------------------------------------------------------
    cfg = sdt_bp(speaker="oliver", precision="bf16")
    sd = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    fn, has_code = build_serving_fn(cfg, sd, device="cuda")
    check(has_code, "SDT-BP takes a template code")
    requests = [(dev_randn(b, L, scale=0.1), dev_randn(b, 32)) for b in (1, 16, 128)]
    kernels.reset_launch_counts()
    seen = []
    for audio, code in requests:
        poses = fn(audio, code)
        torch.cuda.synchronize()
        b = audio.shape[0]
        check(poses.shape == (b, 64, 2, 121), f"poses shape {tuple(poses.shape)}")
        check(bool(torch.isfinite(poses).all()), f"non-finite poses at B={b}")
        seen.append(dict(kernels.LAUNCHES))
    launches = dict(kernels.LAUNCHES)
    growth = {name: [s.get(name, 0) for s in seen] for name in ("mel", "conv1", "stem", "in_act")}
    for name, counts in growth.items():
        per = 21 if name == "in_act" else 1  # in_act: each IN layer after the stem
        check(counts == [per, 2 * per, 3 * per], f"{name} kernel launches per request: {counts}")
        report[name]["launches"] = launches[name]
    # the B = 128 request's second call captures its graph and replays it, the third
    # replays: each runs every kernel once more, and returns the eager call's poses
    eager128 = poses
    again = [fn(*requests[-1]) for _ in range(2)]
    torch.cuda.synchronize()
    executed = {n: kernels.executions()[n] for n in ("mel", "conv1", "stem", "in_act")}
    check(dict(fn.routes) == {"eager": 3, "captured": 1, "replayed": 1}
          and executed == {"mel": 5, "conv1": 5, "stem": 5, "in_act": 5 * 21},
          f"B=128 called again: routes {dict(fn.routes)}, kernels ran {executed}")
    replay_rel = max(_rel_l2(p, eager128) for p in again)
    replay_equal = all(bool(torch.equal(p, eager128)) for p in again)
    check(replay_equal, f"B=128 graph replay vs the eager call: rel L2 {replay_rel}")
    report["serve_replay"] = {"rel_l2_vs_eager": replay_rel, "bit_identical": replay_equal}

    audio, code = requests[-1]
    model16 = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cuda")
    model16.load_state_dict(sd)
    cfg32 = sdt_bp(speaker="oliver", precision="fp32")
    model32 = build_model(cfg32.VOICE2POSE.GENERATOR.NAME, cfg32, device="cuda")
    model32.load_state_dict(sd)
    with torch.inference_mode():
        out16 = model16(M.mel_spectrogram(audio), 64, code).double()
        out32 = model32(M.mel_spectrogram_plain(audio), 64, code, plain=True).double()
    rel_l2 = (torch.linalg.norm(out16 - out32) / torch.linalg.norm(out32)).item()
    corr = torch.corrcoef(torch.stack([out16.flatten(), out32.flatten()]))[0, 1].item()
    check(rel_l2 < 0.05 and corr > 0.999,
          f"bf16 kernel path vs fp32 plain forward: rel L2 {rel_l2}, corr {corr}")
    fwd_ms = cuda_ms(fn, [requests[-1]], 20)
    fps = 128 * 64 / (fwd_ms / 1e3)
    print(f"[serve] SDT-BP bf16 B=1,16,128 ok; launch counts after each request "
          f"{growth}; B=128's graph replay vs its eager call: rel L2 {replay_rel:.3e} "
          f"(bit for bit {replay_equal}); B=128 vs fp32 plain: "
          f"rel L2 {rel_l2:.4e}, corr {corr:.6f}; forward {fwd_ms:.4f} ms = "
          f"{fps:.1f} pose-frames/s", flush=True)
    del model16, model32, out16, out32

    # the in_act kernel at SDT-BP's 21 IN layers after the stem (B = 128, bf16) on
    # conv-like activations (per column a mean of N(0, 1) and a scale of exp(N(0, 0.5));
    # 2-D channels-last, as cuDNN leaves layers 3-7), against the plain path; not counted
    from speechdrivestemplates_tpu_torch.ops import bn_act as BA
    from speechdrivestemplates_tpu_torch.ops import in_act as IA

    in_shapes = [(128, 20, 106), (256, 20, 106), (256, 10, 53), (256, 10, 53),
                 (256, 5, 51)] + [(256, t) for t in (64, 64, 32, 16, 8, 4, 2, 4, 8, 16, 32, 64,
                                                     64, 64, 64, 64)]
    g7 = torch.Generator(device=dev).manual_seed(7)
    in_acts = []
    for sh in in_shapes:
        col = (128, sh[0], 1, 1) if len(sh) == 3 else (128, 1, sh[1])
        x = (torch.randn((128, *sh), generator=g7, device=dev)
             * torch.exp(0.5 * torch.randn(col, generator=g7, device=dev))
             + torch.randn(col, generator=g7, device=dev)).to(bf)
        in_acts.append(x.contiguous(memory_format=torch.channels_last) if x.ndim == 4 else x)
    in_one, in_far, in_err, in_gate = 0, 0, 0.0, True
    with torch.no_grad():
        for x in in_acts:
            k, p = IA.in_act_kernel(x, 0.2), IA.in_act_plain(x, 0.2)
            d = BA.ulp_distance(k, p)
            in_one, in_far = in_one + int((d == 1).sum()), in_far + int((d > 1).sum())
            diff, pf = (k.float() - p.float()).abs(), p.float()
            ulp = torch.ldexp(torch.ones_like(pf), torch.frexp(pf).exponent - 8)
            in_gate &= bool((diff <= ulp + 2e-6 * pf.abs().clamp(min=1)).all())
            in_err = max(in_err, diff.max().item())
            del k, p, d, diff, pf, ulp
    n_in = sum(x.numel() for x in in_acts)
    check(in_gate, "in_act vs the plain path at SDT-BP's 21 layers: beyond one bf16 ulp plus "
                   "2e-6 x max(1, |plain|)")

    def in_sweep(f):
        with torch.no_grad():
            for x in in_acts:
                f(x)

    def in_library(x):
        if x.ndim == 4:
            y = torch.nn.functional.instance_norm(x, eps=1e-5)
        else:
            y = torch.nn.functional.layer_norm(x.transpose(1, 2), (x.shape[1],), eps=1e-5)
        return torch.nn.functional.leaky_relu(y, 0.2)

    in_b, in_by = bound_ms(4.0 * n_in, 2.0 * n_in, "bf16")
    report["in_act"].update(
        max_abs_err=in_err, one_ulp_share=in_one / n_in, beyond_one_ulp_share=in_far / n_in,
        ms=cuda_ms(lambda: in_sweep(lambda x: IA.in_act_kernel(x, 0.2)), [()], 10),
        plain_ms=cuda_ms(lambda: in_sweep(lambda x: IA.in_act_plain(x, 0.2)), [()], 3),
        bound_ms=in_b, bound_by=in_by, library_ms=cuda_ms(lambda: in_sweep(in_library), [()], 10))
    print(f"[serve-in_act] SDT-BP's 21 IN layers at B=128, bf16 ({n_in} elements): kernel vs "
          f"the plain path {in_one / n_in:.3e} of elements one ulp off, {in_far / n_in:.3e} "
          f"further (within 2e-6), max abs err {in_err:.3e}; kernel "
          f"{report['in_act']['ms']:.4f} ms, plain {report['in_act']['plain_ms']:.4f} ms, "
          f"F.instance_norm / F.layer_norm + F.leaky_relu {report['in_act']['library_ms']:.4f} "
          f"ms, bound {in_b:.4f} ms ({in_by}); {card}", flush=True)
    del in_acts

    # ---- 8. command line ---------------------------------------------------------
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    ckpt, wav_path, out = (os.path.join(work, f) for f in ("sdt_bp.pth", "in.wav", "out.npz"))
    torch.save({"epoch": 0, "step": 0,
                "model_state_dict": {"module.netG." + k: v for k, v in sd.items()}}, ckpt)
    pcm = (rng.randn(50000) * 3000).astype(np.int16)
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.serving",
                        ckpt, wav_path, out, "--code-seed", "3", "--device", "cuda"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"serving CLI rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    buf = np.zeros((1, L), np.float32)
    buf[0, :50000] = pcm.astype(np.float32) / 32768.0
    expect = fn(buf, np.random.RandomState(3).randn(1, 32).astype(np.float32))[0]
    with np.load(out) as z:
        got = torch.from_numpy(z["poses"]).to(dev)
    check(got.shape == (64, 2, 121) and bool(torch.isfinite(got).all()),
          f"CLI poses {tuple(got.shape)}")
    cli_rel = (torch.linalg.norm(got - expect) / torch.linalg.norm(expect)).item()
    check(cli_rel < 1e-3, f"CLI output differs from in-process serving: rel L2 {cli_rel}")
    print(f"[cli] {r.stdout.strip()}; rel L2 vs in-process {cli_rel:.3e}", flush=True)

    # ---- 9. kernel probes --------------------------------------------------------
    # the probe entry point resets the launch counts as it starts and reports them
    # as it ends, in its last line
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.profile_kernels",
                        "--conv1-probe", "--shift-probe"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"profile_kernels rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    probe = json.loads(r.stdout.strip().splitlines()[-1])
    check("conv1_probe" in probe and "shift_probe" in probe, f"probe line: {probe}")
    for name in ("conv1", "shift_probe"):
        check(probe["launches"].get(name, 0) > 0,
              f"the probes launched no {name} kernel: {probe['launches']}")
    report["shift_probe"]["launches"] = probe["launches"]["shift_probe"]
    print(f"[probe] profile_kernels rc 0; conv1 probe {probe['conv1_probe']['ms']}, "
          f"rel diff {probe['conv1_probe']['rel_diff_layer1']:.3e}; shift probe "
          f"{probe['shift_probe']['ms']}; launches {probe['launches']}", flush=True)

    # ---- 10. train ----------------------------------------------------------------
    from speechdrivestemplates_tpu_torch.config import apply_overrides
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu_torch.pipelines.trainer import TrainLoop, train_loader
    from speechdrivestemplates_tpu_torch.pipelines import voice2pose as V2P
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (
        Voice2PoseTrainState, train_step)

    root = os.path.join(work, "speakers")
    shutil.rmtree(root, ignore_errors=True)
    # 35 dev clips for phase 13: an eval batch of 32 and a ragged one of 3 (the
    # train clips do not depend on num_dev)
    make_synthetic_speaker(root, "oliver", num_train=64, num_dev=35)
    opts = ["DATASET.ROOT_DIR", root, "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"]
    tcfg = apply_overrides(sdt_bp(), list(opts))  # bf16, TRAIN.BATCH_SIZE 32
    loader = train_loader(tcfg)
    TB = tcfg.TRAIN.BATCH_SIZE
    check(TB == 32 and len(loader) == 2, f"train loader: {len(loader)} batches of {TB}")
    loader.batch_sampler.set_epoch(1)
    batches = list(loader)
    state = Voice2PoseTrainState(tcfg, len(loader.dataset), dev)

    # B1 at the train step's shape, (32, 68266): an even L puts each sample at
    # another byte alignment and the last frame's reflect padding elsewhere
    # than phase 3's (128, 68267); these comparison launches are not counted
    TL = batches[0]["audio"].shape[-1]
    train_mel_err, train_quiet_rel, _ = check_mel(batches[0]["audio"].to(dev),
                                                  f"train batch ({TB}, {TL})")
    report["mel"]["max_abs_err"] = max(report["mel"]["max_abs_err"], train_mel_err)

    kernels.reset_launch_counts()
    losses, _ = train_step(state, batches[0])
    torch.cuda.synchronize()
    one_step = dict(kernels.LAUNCHES)
    check({n: one_step.get(n, 0) for n in ("mel", "conv1", "stem")}
          == {"mel": 1, "conv1": 0, "stem": 0},
          f"one train step launched {one_step}: expected mel 1, conv1 0, stem 0")
    stem_grads = [m.conv.weight.grad for m in state.generator.audio_encoder.layers()[:3]]
    check(all(g is not None and bool(torch.isfinite(g).all()) and g.abs().sum() > 0
              for g in stem_grads), "the stem's weights got no gradient in train mode")
    grads16 = torch.cat([p.grad.float().flatten() for p in state.generator.parameters()])
    reg16 = losses["G_reg_loss"].item()

    # the same step at the same seeded weights in fp32, all plain (no TF32)
    cfg32 = apply_overrides(sdt_bp(precision="fp32"), list(opts))
    state32 = Voice2PoseTrainState(cfg32, len(loader.dataset), dev)
    losses32, _ = train_step(state32, batches[0], plain=True)
    torch.cuda.synchronize()
    check(dict(kernels.LAUNCHES) == one_step, "the all-plain fp32 step launched a kernel")
    grads32 = torch.cat([p.grad.flatten() for p in state32.generator.parameters()])
    reg32 = losses32["G_reg_loss"].item()
    reg_rel = abs(reg16 - reg32) / abs(reg32)
    grad_cos = torch.nn.functional.cosine_similarity(grads16.double(), grads32.double(),
                                                     dim=0).item()
    check(reg_rel <= 0.02 and grad_cos >= 0.99,
          f"bf16 step vs fp32 all-plain step: G_reg_loss {reg16} vs {reg32} (rel {reg_rel}), "
          f"gradient cosine {grad_cos}")
    del state, state32, grads16, grads32, stem_grads

    # learning: 30 steps at LR 1e-3 through the loader
    lcfg = apply_overrides(sdt_bp(), opts + ["TRAIN.LR", "1e-3"])
    state = Voice2PoseTrainState(lcfg, len(loader.dataset), dev)
    history, epoch = [], 0
    while len(history) < 30:
        epoch += 1
        loader.batch_sampler.set_epoch(epoch)
        for b in loader:
            step_losses, _ = train_step(state, b)
            history.append(torch.stack(list(step_losses.values())))
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    check(train_launches.get("mel", 0) == 1 + len(history) and not train_launches.get("conv1")
          and not train_launches.get("stem"),
          f"train phase launches {train_launches} over {1 + len(history)} kernel-path steps")
    hist = torch.stack(history).cpu()
    names = list(step_losses)
    check(bool(torch.isfinite(hist).all()), f"non-finite training losses: {hist}")
    reg = hist[:, names.index("G_reg_loss")].tolist()
    first4, last4 = sum(reg[:4]) / 4, sum(reg[-4:]) / 4
    check(last4 < first4, f"G_reg_loss did not fall over {len(reg)} steps: first 4 mean "
                          f"{first4}, last 4 mean {last4}")
    report["mel"]["launches"] += train_launches["mel"]

    # the step on device-resident batches, loader excluded
    def to_dev(x):
        return {k: to_dev(v) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    dev_batches = [(to_dev(b),) for b in batches]
    step_ms = cuda_ms(lambda b: train_step(state, b), dev_batches, 20)
    del state, dev_batches, batches

    # the trainer loop with its loader over long epochs: a speaker of 1,600
    # clips (50 steps an epoch), two epochs on one persistent worker pool; the
    # first epoch starts the workers, the second runs on a warm pool
    long_root = os.path.join(work, "speakers_long")
    shutil.rmtree(long_root, ignore_errors=True)
    make_synthetic_speaker(long_root, "oliver", num_train=50 * TB, num_dev=0)
    long_cfg = apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", long_root,
                                          "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"])
    long_loader = train_loader(long_cfg, dev)  # page-locked batches, prefetched
    state = Voice2PoseTrainState(long_cfg, len(long_loader.dataset), dev)
    long_loop, loop_rates, gstep = TrainLoop(state, long_loader), [], 0
    for e in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        end = long_loop.epoch(e, gstep)[0]
        torch.cuda.synchronize()
        loop_rates.append((end - gstep) / (time.perf_counter() - t0))
        steps, gstep = end - gstep, end
    check(steps == 50, f"long epoch: {steps} steps")
    # the loader alone on the same warm pool: a third epoch's batches copied to
    # the card, no train step
    long_loader.batch_sampler.set_epoch(3)
    torch.cuda.synchronize()
    t0, fetched = time.perf_counter(), 0
    for b in long_loader:
        to_dev(b)
        fetched += 1
    torch.cuda.synchronize()
    loader_rate = fetched / (time.perf_counter() - t0)
    workers = long_cfg.SYS.NUM_WORKERS
    train_line = {"train": {"card": card, "model": "SDT-BP", "precision": "bf16", "batch": TB,
                            "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
                            "loop_steps_per_s_with_loader": loop_rates[1],
                            "loop_steps_per_s_first_epoch": loop_rates[0],
                            "loop_epochs": 2, "loop_steps_per_epoch": steps,
                            "loop_clips": len(long_loader.dataset), "loader_workers": workers,
                            "loader_alone_batches_per_s": loader_rate,
                            "reg_loss_bf16_vs_fp32_rel": reg_rel, "grad_cos": grad_cos,
                            "reg_loss_first4": first4, "reg_loss_last4": last4,
                            "mel_train_shape_max_abs_err": train_mel_err}}
    print(f"[train] SDT-BP bf16 B={TB}: mel kernel vs plain at ({TB}, {TL}) max abs err "
          f"{train_mel_err:.3e} (rtol 1e-3, atol 1e-4), quiet half max rel err "
          f"{train_quiet_rel:.3e} (rtol 1e-3); one step launched mel 1, conv1 0, stem 0; stem "
          f"weights got gradients; G_reg_loss {reg16:.6f} vs fp32 all-plain {reg32:.6f} "
          f"(rel {reg_rel:.3e}, <= 0.02), gradient cosine {grad_cos:.6f} (>= 0.99); "
          f"{len(reg)} steps at LR 1e-3: G_reg_loss first-4 mean {first4:.5f} -> last-4 "
          f"{last4:.5f}; step {step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s "
          f"(device-resident batches); trainer loop with loader ({workers} workers, "
          f"{len(long_loader.dataset)} clips, 2 epochs of {steps} steps): "
          f"{loop_rates[0]:.2f} steps/s in the first epoch, {loop_rates[1]:.2f} in the second; "
          f"the loader alone (a third epoch, batches copied to the card) {loader_rate:.2f} "
          f"batches/s",
          flush=True)
    del state, long_loader, long_loop, loader

    # ---- 11. training command line ---------------------------------------------------
    runs = os.path.join(work, "runs")
    shutil.rmtree(runs, ignore_errors=True)
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.main",
                        "--device", "cuda", "--tag", "chip_smoke", *opts,
                        "SYS.OUTPUT_DIR", runs, "TRAIN.NUM_EPOCHS", "2"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"training CLI rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    ckpt = summary.get("checkpoint")
    check(bool(ckpt) and os.path.exists(ckpt) and summary["steps"] == 4,
          f"training CLI line: {summary}")
    served = os.path.join(work, "trained_out.npz")
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.serving",
                        ckpt, wav_path, served, "--device", "cuda"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"serving CLI on the trained checkpoint rc {r.returncode}:\n"
                             f"{r.stdout}\n{r.stderr}")
    with np.load(served) as z:
        got = z["poses"]
    check(got.shape == (64, 2, 121) and bool(np.isfinite(got).all()),
          f"poses served from the trained checkpoint: {got.shape}")
    print(f"[train-cli] 2 epochs, {summary['steps']} steps, last losses "
          f"{summary['losses']}; {os.path.relpath(ckpt, ROOT)} served: {r.stdout.strip()}",
          flush=True)

    # ---- 12. pose2pose ----------------------------------------------------------------
    from speechdrivestemplates_tpu_torch.config import pose2pose
    from speechdrivestemplates_tpu_torch.pipelines import pose2pose as P2P
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    popts = ["DATASET.ROOT_DIR", root, "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"]
    pcfg = apply_overrides(pose2pose(), popts + ["TRAIN.LR", "1e-3"])
    ploader = train_loader(pcfg)
    pstate = P2P.Pose2PoseTrainState(pcfg, len(ploader.dataset), dev)
    ploader.batch_sampler.set_epoch(1)
    pbatches = list(ploader)
    kernels.reset_launch_counts()
    plosses, presults = P2P.train_step(pstate, pbatches[0])
    torch.cuda.synchronize()
    check(sum(kernels.LAUNCHES.values()) == 0, f"a Pose2Pose step launched {dict(kernels.LAUNCHES)}")
    idx = pbatches[0]["clip_index"].to(dev)
    rest = torch.ones(len(ploader.dataset), dtype=torch.bool, device=dev)
    rest[idx] = False
    for bank in ("clip_code_mu", "clip_code_logvar"):
        b = getattr(pstate, bank)
        check(torch.equal(b[idx], presults[bank].float()) and not b[rest].any(),
              f"Pose2Pose {bank} after one step: not the step's rows at clip_index and "
              "zeros elsewhere")
    phist = [torch.stack(list(plosses.values()))]
    for b in pbatches[1:]:
        phist.append(torch.stack(list(P2P.train_step(pstate, b)[0].values())))
    epoch = 1
    while len(phist) < 30:
        epoch += 1
        ploader.batch_sampler.set_epoch(epoch)
        for b in ploader:
            phist.append(torch.stack(list(P2P.train_step(pstate, b)[0].values())))
    phist = torch.stack(phist[:30]).cpu()
    check(bool(torch.isfinite(phist).all()), f"non-finite Pose2Pose losses: {phist}")
    preg = phist[:, list(plosses).index("reg_loss")].tolist()
    p_first4, p_last4 = sum(preg[:4]) / 4, sum(preg[-4:]) / 4
    check(p_last4 < p_first4, f"Pose2Pose reg_loss did not fall over 30 steps: first 4 mean "
                              f"{p_first4}, last 4 mean {p_last4}")
    p_dev = [(to_dev(b),) for b in pbatches]
    p_step_ms = cuda_ms(lambda b: P2P.train_step(pstate, b), p_dev, 20)
    ae_ckpt = os.path.join(work, "pose2pose.pth")
    pstate.save_checkpoint(ae_ckpt, 1, pstate.step)
    print(f"[pose2pose] B={TB} fp32: one step launched no kernel and scattered its mu and "
          f"logvar into the banks at clip_index (other rows zero); 30 steps at LR 1e-3: "
          f"reg_loss first-4 mean {p_first4:.5f} -> last-4 {p_last4:.5f}; step "
          f"{p_step_ms:.4f} ms = {1e3 / p_step_ms:.2f} steps/s (device-resident batches)",
          flush=True)
    del pstate, p_dev, pbatches, ploader

    # ---- 13. eval -------------------------------------------------------------------
    eopts = opts + ["VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_ckpt, "TEST.SAVE_VIDEO", "False",
                    "SYS.OUTPUT_DIR", os.path.join(work, "eval")]
    ecfg = apply_overrides(sdt_bp(), list(eopts))  # bf16, TEST.BATCH_SIZE 32
    eloader = trainer.eval_loader(ecfg)
    ebatches = list(eloader)
    check([b["audio"].shape[0] for b in ebatches] == [32, 3],
          f"eval batches {[b['audio'].shape[0] for b in ebatches]}")
    kernels.reset_launch_counts()
    tested = trainer.test(ecfg, ckpt, "chip_smoke_eval", dev)
    torch.cuda.synchronize()
    eval_launches = dict(kernels.LAUNCHES)
    check({n: eval_launches.get(n, 0) for n in ("mel", "conv1", "stem", "in_act")}
          == {"mel": 2, "conv1": 2, "stem": 2, "in_act": 2 * 21},
          f"the test run over 2 eval batches launched {eval_launches}")
    em = tested["metrics"]
    check(all(np.isfinite(em[k]) for k in ("L2_dist", "lip_sync_error_n", "FGD_mu",
                                           "FGD_mu_logvar")), f"test metrics {em}")
    # the fp32 all-plain evaluation at the same weights and the codes the test drew
    codes = []
    for t in (1, 2):
        with np.load(os.path.join(tested["output_dir"], "results",
                                  f"epoch0-TEST-step{t}.npz")) as z:
            codes.append(torch.from_numpy(z["condition_code"]).to(dev))
    state32 = Voice2PoseTrainState(apply_overrides(sdt_bp(precision="fp32"), list(eopts)),
                                   None, dev)
    state32.load_pth(ckpt)
    l2_sum = 0.0
    for b, code in zip(ebatches, codes):
        l2_sum += V2P.eval_step(state32, b, fixed_code=code, plain=True)[0]["L2_dist"].item() \
            * b["audio"].shape[0]
    torch.cuda.synchronize()
    check(dict(kernels.LAUNCHES) == eval_launches, "the all-plain fp32 evaluation launched a kernel")
    l2_plain = l2_sum / 35
    l2_rel = abs(em["L2_dist"] - l2_plain) / l2_plain
    check(l2_rel <= 0.02, f"test L2_dist {em['L2_dist']} vs fp32 all-plain {l2_plain} "
                          f"(rel {l2_rel})")
    # the kernels at the ragged batch's shapes, with the checkpoint's stem weights
    eval_mel_err, _, _ = check_mel(ebatches[1]["audio"].to(dev), "ragged eval batch (3, 68266)")
    report["mel"]["max_abs_err"] = max(report["mel"]["max_abs_err"], eval_mel_err)
    state16 = Voice2PoseTrainState(ecfg, None, dev)
    state16.load_pth(ckpt)
    ws = [m.conv.weight.detach() for m in state16.generator.audio_encoder.layers()[:3]]
    emel = M.mel_spectrogram_plain(ebatches[1]["audio"].to(dev))
    k16 = S.stem_kernel(emel, *ws, 0.2, bf).float()
    ref32 = S.stem_plain(emel, *ws, 0.2, torch.float32)
    e16 = (k16 - ref32).abs().flatten()
    ragged_q99 = torch.quantile(e16, 0.99).item()
    check(k16.shape == ref32.shape == (3, *S.stem_dims(emel.shape[-1]), 128)
          and ragged_q99 < 0.05 and e16.mean().item() < 0.02,
          f"stem kernels bf16 vs fp32 plain at (3, 80, 427): p99 {ragged_q99}")
    eval_ms = cuda_ms(lambda b: V2P.eval_step(state16, b), [(to_dev(ebatches[0]),)], 10)
    for name in ("mel", "conv1", "stem", "bn_act", "in_act"):
        report[name]["launches"] += eval_launches.get(name, 0)
    chain_line = {"chain": {"card": card, "pose2pose_step_ms": p_step_ms,
                            "pose2pose_reg_loss_first4": p_first4,
                            "pose2pose_reg_loss_last4": p_last4,
                            "eval_ms_per_batch32": eval_ms, "eval_metrics": em,
                            "eval_l2_fp32_plain": l2_plain, "eval_l2_rel": l2_rel,
                            "eval_launches": {n: eval_launches[n] for n in ("mel", "conv1",
                                                                            "stem")}}}
    print(f"[eval] SDT-BP bf16 test of {os.path.relpath(ckpt, ROOT)} on 35 dev clips (batches "
          f"32, 3): launches mel 2, conv1 2, stem 2; L2_dist {em['L2_dist']:.4f} vs fp32 "
          f"all-plain {l2_plain:.4f} (rel {l2_rel:.3e}, <= 0.02); lip_sync_error_n "
          f"{em['lip_sync_error_n']:.5f}; FGD_mu {em['FGD_mu']:.4f}, FGD_mu_logvar "
          f"{em['FGD_mu_logvar']:.4f}; mel kernel at (3, 68266) max abs err "
          f"{eval_mel_err:.3e}; stem kernels at (3, 80, 427) bf16 p99 {ragged_q99:.4f} "
          f"(< 0.05); eval forward {eval_ms:.4f} ms per batch of 32", flush=True)
    del state32, state16, ebatches, eloader

    # ---- 14. chain through the command line -----------------------------------------
    chain = os.path.join(work, "chain")
    shutil.rmtree(chain, ignore_errors=True)
    common = [*opts, "TEST.SAVE_VIDEO", "False", "SYS.OUTPUT_DIR", chain,
              "TRAIN.NUM_EPOCHS", "2"]

    def cli(flags, *overrides):
        """``main`` with ``flags``, then the common overrides, then ``overrides``."""
        r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.main",
                            "--device", "cuda", *flags, *common, *overrides], cwd=ROOT,
                           env=env, capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"main {flags} rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    c_p2p = cli(["--config_file", "configs/pose2pose.yaml", "--tag", "p2p"])
    ae_chain = c_p2p["checkpoint"]
    c_bp = cli(["--config_file", "configs/voice2pose_sdt_bp.yaml", "--tag", "bp"],
               "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_chain, "TRAIN.VALIDATE", "True")
    check(c_bp["steps"] == 4 and np.isfinite(c_bp["val_metrics"]["FGD_mu"]),
          f"SDT-BP CLI line: {c_bp}")
    c_test = cli(["--config_file", "configs/voice2pose_sdt_bp.yaml", "--tag", "test",
                  "--test_only", "--checkpoint", c_bp["checkpoint"]],
                 "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_chain)
    test_keys = ("L2_dist", "lip_sync_error_n", "FGD_mu", "FGD_mu_logvar")
    check(all(np.isfinite(c_test["metrics"].get(k, np.nan)) for k in test_keys),
          f"test CLI line: {c_test}")
    c_vae = cli(["--config_file", "configs/voice2pose_sdt_vae.yaml", "--tag", "vae"],
                "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_chain)
    from speechdrivestemplates_tpu_torch.utils.weights import read_pth

    check(torch.equal(read_pth(c_vae["checkpoint"])["clips_code"],
                      read_pth(ae_chain)["clip_code_mu"]),
          "SDT-VAE's checkpoint does not hold the Pose2Pose bank unchanged")
    chain_s = time.perf_counter() - t0
    chain_line["chain"].update(cli_test_metrics=c_test["metrics"], cli_seconds=chain_s)
    print(f"[chain-cli] pose2pose -> SDT-BP (AE_CHECKPOINT, validation) -> --test_only -> "
          f"SDT-VAE, 2 epochs each, in {chain_s:.1f} s; test metrics "
          f"{ {k: round(c_test['metrics'][k], 4) for k in test_keys} }; the SDT-VAE "
          f"checkpoint holds the Pose2Pose bank unchanged", flush=True)

    # ---- 15. the graphed loop on the device cache, resume, preemption ---------------
    import signal
    import threading

    from speechdrivestemplates_tpu_torch.pipelines.checkpoint import checkpoint_key, resume_path
    from speechdrivestemplates_tpu_torch.pipelines.trainer import PIPELINES, stage_device_cache

    gopts = ["DATASET.ROOT_DIR", long_root, "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO",
             "False", "DATASET.CACHING", "True", "DATASET.DEVICE_CACHE", "on"]
    gcfg = apply_overrides(sdt_bp(), list(gopts))
    gloader = train_loader(gcfg, dev)
    t0 = time.perf_counter()
    cache_bp, cache_line = stage_device_cache(gcfg, gloader, dev,
                                              PIPELINES["Voice2Pose"].device_keys)
    stage_s = time.perf_counter() - t0
    check(cache_bp is not None, cache_line)
    caches = {"Voice2Pose": cache_bp,
              "Pose2Pose": {k: cache_bp[k] for k in PIPELINES["Pose2Pose"].device_keys}}

    def cached_loop(preset, K, capturable, deterministic, loader=None, cache=None):
        """Two 50-step epochs of the 1,600-clip speaker from the device cache
        at K steps a dispatch: the loop's steps/s in each epoch (host clock,
        synchronized), every step's loss row, the launch counts, the state.
        ``loader`` and ``cache`` default to phase 15's (parted poses)."""
        cfg = apply_overrides(preset(), gopts + ["TRAIN.STEPS_PER_DISPATCH", str(K)])
        loader = gloader if loader is None else loader
        cache = caches[cfg.PIPELINE_TYPE] if cache is None else cache
        state = PIPELINES[cfg.PIPELINE_TYPE].state(cfg, len(loader.dataset), dev,
                                                   capturable=capturable)
        torch.backends.cudnn.deterministic = deterministic
        loop = TrainLoop(state, loader, cache, K, collect=True)
        kernels.reset_launch_counts()
        rates, gs = [], 0
        try:
            for e in (1, 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                end = loop.epoch(e, gs)[0]
                torch.cuda.synchronize()
                rates.append((end - gs) / (time.perf_counter() - t0))
                gs = end
        finally:
            torch.backends.cudnn.deterministic = False
        counts = {"launches": dict(kernels.LAUNCHES), "captured": dict(kernels.CAPTURED),
                  "replayed": dict(kernels.REPLAYED), "executed": dict(kernels.executions())}
        rows = torch.cat(loop.history).cpu()
        check(gs == 100 and rows.shape[0] == 100 and bool(torch.isfinite(rows).all()),
              f"{cfg.PIPELINE_TYPE} K={K}: {gs} steps, rows {tuple(rows.shape)} finite "
              f"{bool(torch.isfinite(rows).all())}")
        return SimpleNamespace(state=state, rows=rows, rates=rates, counts=counts,
                               graphs=sorted(getattr(loop.runner, "graphs", {})),
                               names=loop.names)

    graph_line = {"card": card, "clips": len(gloader.dataset), "batch": TB,
                  "steps_per_epoch": 50, "cache_stage_s": stage_s, "cache_line": cache_line,
                  "loader_loop_steps_per_s": loop_rates[1]}
    for preset, name in ((sdt_bp, "sdt_bp_bf16"), (pose2pose, "pose2pose_fp32")):
        # the default K = 1 (plain Adam), then the gate pair under one capturable Adam
        # with cuDNN deterministic: K = 1 eager from the cache, K = 8 graphed
        k1 = cached_loop(preset, 1, False, False)
        k1c = cached_loop(preset, 1, True, True)
        k8 = cached_loop(preset, 8, True, True)
        check(k8.graphs == [2, 8], f"{name}: graphs captured for chunk lengths {k8.graphs}")
        k8_err = (k8.rows - k1c.rows).abs().max().item()
        check(torch.equal(k8.rows, k1c.rows),
              f"{name}: K=8 graphed loss rows differ from K=1 eager under the same capturable "
              f"Adam: max abs {k8_err}")
        sd8, sd1 = k8.state.state_dict(), k1c.state.state_dict()
        check(all(torch.equal(sd8[k], sd1[k]) for k in sd1),
              f"{name}: K=8 weights differ from K=1's after 100 steps")
        cap_rel = ((k1.rows - k1c.rows).abs() / k1c.rows.abs().clamp_min(1e-12)).max().item()
        entry = {"k1_steps_per_s": k1.rates, "k1_capturable_steps_per_s": k1c.rates,
                 "k8_steps_per_s": k8.rates, "k8_step_ms": 1e3 / k8.rates[1],
                 "k1_step_ms": 1e3 / k1.rates[1], "k8_rows_equal_k1_capturable": True,
                 "capturable_vs_plain_adam_max_rel_loss_diff": cap_rel,
                 "k8_counts": k8.counts}
        if preset is sdt_bp:
            c = k8.counts
            check(c["executed"].get("mel") == 100 and c["captured"].get("mel") == 8 + 2
                  and c["launches"].get("mel") == 8 + 10 and c["replayed"].get("mel") == 92
                  and k1.counts["executed"].get("mel") == 100,
                  f"SDT-BP K=8: mel launches {c}; K=1 {k1.counts}: expected 100 executions "
                  "(8 eager + 92 replayed; 10 captured)")
            # the wrapper's own count: host launches, the 10 captured ones included
            report["mel"]["launches"] += sum(r.counts["launches"]["mel"] for r in (k1, k1c, k8))
        else:
            check(not k8.counts["launches"], f"Pose2Pose launched {k8.counts}")
        graph_line[name] = entry
        print(f"[graphed] {name} B={TB}, 1,600 clips on the card, two 50-step epochs: "
              f"K=1 {k1.rates[1]:.2f} steps/s ({entry['k1_step_ms']:.3f} ms a step), K=1 "
              f"capturable {k1c.rates[1]:.2f}, K=8 {k8.rates[1]:.2f} steps/s "
              f"({entry['k8_step_ms']:.3f} ms; first epoch {k8.rates[0]:.2f}, captures "
              f"included); K=8 rows = K=1 capturable rows bit for bit over 100 steps, weights "
              f"too; capturable vs plain Adam: max rel loss diff {cap_rel:.3e}; K=8 counts "
              f"{k8.counts}", flush=True)
        del k1, k1c, k8
    del caches, cache_bp, gloader

    # resume through the command line: 4 epochs straight, against the straight run's
    # epoch-2 checkpoint resumed in a copy of its directory for 2 more (K = 8, the
    # cache, 320 clips: 10 steps an epoch, a chunk of 8 and one of 2)
    rruns = os.path.join(work, "resume_runs")
    shutil.rmtree(rruns, ignore_errors=True)
    ropts = [*gopts, "DATASET.SUBSET", "320", "TRAIN.STEPS_PER_DISPATCH", "8",
             "SYS.OUTPUT_DIR", rruns, "SYS.LOG_INTERVAL", "5", "TRAIN.NUM_EPOCHS", "4"]

    def main_cli(*args, timeout=300):
        r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.main",
                            "--device", "cuda", *args], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=timeout)
        check(r.returncode == 0, f"main {args[:4]} rc {r.returncode}:\n{r.stdout}\n"
                                 f"{r.stderr[-4000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    straight = main_cli("--tag", "straight", *ropts)
    check(straight["steps"] == 40, f"straight run: {straight}")
    split_dir = straight["output_dir"] + "_copy"
    shutil.copytree(straight["output_dir"], split_dir)
    ck2 = glob.glob(os.path.join(split_dir, "checkpoints", "checkpoint_epoch-2_*.pth"))
    check(len(ck2) == 1, f"epoch-2 checkpoints in the copy: {ck2}")
    for f in glob.glob(os.path.join(split_dir, "checkpoints", "checkpoint_epoch-[34]_*")):
        os.remove(f)
    resumed = main_cli("--tag", "straight", "--resume_from", ck2[0], *ropts)
    resume_s = time.perf_counter() - t0
    check(resumed["steps"] == 40 and resumed["resumed_from"] == ck2[0]
          and os.path.basename(resumed["checkpoint"])
          == os.path.basename(straight["checkpoint"]), f"resumed run: {resumed}")
    wa, wb = read_pth(straight["checkpoint"]), read_pth(resumed["checkpoint"])
    ra, rb = (torch.load(resume_path(c), map_location="cpu", weights_only=True)
              for c in (straight["checkpoint"], resumed["checkpoint"]))
    moments = [(sa[k], sb[k]) for oa, ob in zip(ra["optimizers"], rb["optimizers"])
               for sa, sb in zip(oa["state"].values(), ob["state"].values())
               for k in ("exp_avg", "exp_avg_sq", "step")]
    pairs = [(wa[k], wb[k]) for k in wa] + moments
    resume_bitwise = all(torch.equal(a, b) for a, b in pairs)
    resume_err = max((a.double() - b.double()).abs().max().item() for a, b in pairs)
    # separate processes: cuDNN may pick a non-deterministic backward algorithm,
    # so the gate allows fp32 round-off accumulated over 20 Adam steps
    check(all(torch.allclose(a.double(), b.double(), rtol=1e-3, atol=1e-5) for a, b in pairs)
          and ra["global_step"] == rb["global_step"] == 40 and ra["step"] == rb["step"],
          f"resume: weights and moments differ from the straight run by {resume_err}")
    print(f"[resume] CLI, SDT-BP bf16, K=8, the cache, 320 clips: 4 epochs straight vs epoch 2 "
          f"+ --resume_from + 2 epochs: weights and Adam moments bit for bit: "
          f"{resume_bitwise} (max abs diff {resume_err:.3e}; gate rtol 1e-3, atol 1e-5), "
          f"global step 40 both; {resume_s:.1f} s", flush=True)

    # preemption: SIGTERM after the first logged step, exit 143, an epoch-(E-1)
    # checkpoint with its resume file; TRAIN.AUTO_RESUME continues it
    pre_opts = [*ropts, "TRAIN.NUM_EPOCHS", "500", "TRAIN.CHECKPOINT_INTERVAL", "1000",
                "TRAIN.AUTO_RESUME", "True", "SYS.LOG_INTERVAL", "1"]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "speechdrivestemplates_tpu_torch.main",
                             "--device", "cuda", "--tag", "pre", *pre_opts], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(300, proc.kill)
    killer.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "global_step" in line:
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + rest
    check(proc.returncode == 143 and "Preemption checkpoint saved" in out,
          f"preempted run rc {proc.returncode}:\n{out[-4000:]}")
    pre_ck = glob.glob(os.path.join(rruns, "*_voice2pose_sdt_bp-TRAIN-pre", "checkpoints",
                                    "*.pth"))
    check(len(pre_ck) == 1 and os.path.exists(resume_path(pre_ck[0])),
          f"preemption checkpoints {pre_ck}")
    pe, ps = checkpoint_key(pre_ck[0])
    cont = main_cli("--tag", "pre", *pre_opts, "TRAIN.NUM_EPOCHS", str(pe + 1))
    check(cont.get("resumed_from") == pre_ck[0] and cont["steps"] == ps + 10,
          f"auto-resumed run from {pre_ck[0]}: {cont}")
    preempt_s = time.perf_counter() - t0
    print(f"[preempt] SIGTERM after the first logged step: rc 143, "
          f"{os.path.basename(pre_ck[0])} with its resume file; TRAIN.AUTO_RESUME continued "
          f"from global step {ps} and finished epoch {pe + 1} at step {cont['steps']}; "
          f"{preempt_s:.1f} s", flush=True)
    graph_line.update(resume_bitwise=resume_bitwise, resume_max_abs_diff=resume_err,
                      resume_s=resume_s, preempt_checkpoint=os.path.basename(pre_ck[0]),
                      preempt_s=preempt_s)

    # ---- 16. s2g-GAN: serving, training, the graphed loop, the command line ----------
    from speechdrivestemplates_tpu_torch.config import s2g

    def in_kernels(counts):  # none runs in train mode
        return {n: counts.get(n, 0) for n in ("conv1", "stem", "bn_act", "in_act")}

    # (a) serving: seeded weights, BN statistics moved by a few train-mode forwards
    scfg = s2g(precision="bf16")
    model = build_model(scfg.VOICE2POSE.GENERATOR.NAME, scfg, device="cuda").train()
    with torch.no_grad():
        for _ in range(3):
            model(M.mel_spectrogram_plain(dev_randn(16, L, scale=0.1)), 64, None)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    check(not torch.equal(sd["audio_encoder.specgram_encoder_2d.0.0.norm.running_var"],
                          torch.ones(64, device=dev)), "s2g: BN statistics did not move")
    fn, has_code = build_serving_fn(scfg, sd, device="cuda")
    check(not has_code, "s2g takes no template code")
    requests = [dev_randn(b, L, scale=0.1) for b in (1, 16, 128)]
    kernels.reset_launch_counts()
    seen = []
    for audio in requests:
        poses = fn(audio)
        torch.cuda.synchronize()
        b = audio.shape[0]
        check(poses.shape == (b, 64, 2, 121) and bool(torch.isfinite(poses).all()),
              f"s2g poses at B={b}: {tuple(poses.shape)}")
        seen.append(dict(kernels.LAUNCHES))
    s_growth = {n: [s.get(n, 0) for s in seen]
                for n in ("mel", "conv1", "stem", "bn_act", "in_act")}
    check(s_growth == {"mel": [1, 2, 3], "conv1": [0, 0, 0], "stem": [0, 0, 0],
                       "bn_act": [24, 48, 72], "in_act": [0, 0, 0]},
          f"s2g serving launches per request: {s_growth}")
    # the 2-D encoder's 8 BN layers channels-last, the 16 1-D ones contiguous
    check(dict(kernels.LAYOUTS) == {("bn_act", "channels_last"): 24,
                                    ("bn_act", "contiguous"): 48},
          f"s2g serving bn_act launches by layout over 3 requests: {dict(kernels.LAYOUTS)}")
    report["mel"]["launches"] += 3
    report["bn_act"]["launches"] += 72
    audio = requests[-1]
    model16 = build_model(scfg.VOICE2POSE.GENERATOR.NAME, scfg, device="cuda")
    model16.load_state_dict(sd)
    scfg32 = s2g(precision="fp32")
    model32 = build_model(scfg32.VOICE2POSE.GENERATOR.NAME, scfg32, device="cuda")
    model32.load_state_dict(sd)
    with torch.inference_mode():
        out16 = model16(M.mel_spectrogram(audio), 64, None).double()
        out32 = model32(M.mel_spectrogram_plain(audio), 64, None, plain=True).double()
    s_rel = (torch.linalg.norm(out16 - out32) / torch.linalg.norm(out32)).item()
    s_corr = torch.corrcoef(torch.stack([out16.flatten(), out32.flatten()]))[0, 1].item()
    check(s_rel < 0.05 and s_corr > 0.999,
          f"s2g bf16 forward vs fp32 plain: rel L2 {s_rel}, corr {s_corr}")
    s_fwd_ms = cuda_ms(fn, [(audio,)], 20)
    print(f"[s2g-serve] bf16 B=1,16,128 ok; launches after each request {s_growth}; B=128 vs "
          f"fp32 plain: rel L2 {s_rel:.4e}, corr {s_corr:.6f}; forward {s_fwd_ms:.4f} ms = "
          f"{128 * 64 / (s_fwd_ms / 1e3):.1f} pose-frames/s", flush=True)
    del model32, out16, out32, requests, fn

    # the bn_act kernel at s2g's 24 BN layers (B = 128, bf16, the moved statistics) on
    # activations about each channel's running mean, against the plain path; not counted
    from speechdrivestemplates_tpu_torch.models.blocks import ConvNormRelu
    from speechdrivestemplates_tpu_torch.ops import bn_act as BA

    bns = [m.norm for m in model16.modules() if isinstance(m, ConvNormRelu) and m.norm is not None]
    bn_shapes = [(64, 80, 427), (64, 40, 213), (128, 40, 213), (128, 20, 106), (256, 20, 106),
                 (256, 10, 53), (256, 10, 53), (256, 5, 51)] + [
        (256, t) for t in (64, 64, 32, 16, 8, 4, 2, 4, 8, 16, 32, 64, 64, 64, 64, 64)]
    check(len(bns) == len(bn_shapes) == 24
          and all(bn.running_mean.numel() == sh[0] for bn, sh in zip(bns, bn_shapes)),
          f"s2g's BN layers: {[bn.running_mean.numel() for bn in bns]}")
    g16 = torch.Generator(device=dev).manual_seed(16)
    acts = []
    for bn, sh in zip(bns, bn_shapes):
        per = (-1,) + (1,) * (len(sh) - 1)
        x = (torch.randn((128, *sh), generator=g16, device=dev)
             * bn.running_var.sqrt().view(per) + bn.running_mean.view(per)).to(bf)
        # the 2-D layers channels-last, as the serving call hands them
        acts.append(x.contiguous(memory_format=torch.channels_last) if x.ndim == 4 else x)
    bn_ulps, bn_exact, bn_err = 0, 0, 0.0
    with torch.no_grad():
        for bn, x in zip(bns, acts):
            k, p = BA.bn_act_kernel(x, bn, 0.2), BA.bn_act_plain(x, bn, 0.2)
            d = BA.ulp_distance(k, p)
            bn_ulps, bn_exact = max(bn_ulps, int(d.max())), bn_exact + int((d == 0).sum())
            bn_err = max(bn_err, (k.float() - p.float()).abs().max().item())
            del k, p, d
    n_bn = sum(x.numel() for x in acts)
    check(bn_ulps <= 1, f"bn_act vs the plain path at s2g's 24 layers: {bn_ulps} ulps")

    def bn_sweep(f):
        with torch.no_grad():
            for bn, x in zip(bns, acts):
                f(x, bn)

    bn_b, bn_by = bound_ms(4.0 * n_bn + 16 * sum(sh[0] for sh in bn_shapes), 2.0 * n_bn, "bf16")
    report["bn_act"].update(
        max_abs_err=bn_err, ulps=bn_ulps, bit_equal_share=bn_exact / n_bn,
        ms=cuda_ms(lambda: bn_sweep(lambda x, bn: BA.bn_act_kernel(x, bn, 0.2)), [()], 10),
        plain_ms=cuda_ms(lambda: bn_sweep(lambda x, bn: BA.bn_act_plain(x, bn, 0.2)), [()], 3),
        bound_ms=bn_b, bound_by=bn_by,
        library_ms=cuda_ms(lambda: bn_sweep(lambda x, bn: torch.nn.functional.leaky_relu(
            torch.nn.functional.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                                           bn.bias, False, 0.0, 1e-5), 0.2)), [()], 10))
    print(f"[s2g-bn_act] s2g's 24 BN layers at B=128, bf16 ({n_bn} elements): kernel vs the "
          f"plain path within {bn_ulps} ulp, {bn_exact / n_bn:.6%} bit for bit, max abs err "
          f"{bn_err:.3e}; kernel {report['bn_act']['ms']:.4f} ms, plain "
          f"{report['bn_act']['plain_ms']:.4f} ms, F.batch_norm + F.leaky_relu "
          f"{report['bn_act']['library_ms']:.4f} ms, bound {bn_b:.4f} ms ({bn_by})", flush=True)
    del model16, acts, bns

    # (b) training, B = 32, on phase 10's speaker
    sopts = opts + ["SYS.NUM_WORKERS", "8"]
    stcfg = apply_overrides(s2g(), list(sopts))
    sloader = train_loader(stcfg)
    sloader.batch_sampler.set_epoch(1)
    sbatches = list(sloader)
    check("speaker_stat_global" in sbatches[0], "s2g batches lack speaker_stat_global")
    state = Voice2PoseTrainState(stcfg, len(sloader.dataset), dev)
    kernels.reset_launch_counts()
    losses, _ = train_step(state, sbatches[0])
    torch.cuda.synchronize()
    one_step = dict(kernels.LAUNCHES)
    check({n: one_step.get(n, 0) for n in ("mel", "conv1", "stem")}
          == {"mel": 1, "conv1": 0, "stem": 0},
          f"one s2g train step launched {one_step}: expected mel 1, conv1 0, stem 0")

    def flat_grads(module):
        return torch.cat([p.grad.double().flatten() for p in module.parameters()])

    g16, d16 = flat_grads(state.generator), flat_grads(state.discriminator)
    l16 = {k: losses[k].item() for k in ("G_reg_loss", "D_pose_gan_loss")}
    state32 = Voice2PoseTrainState(apply_overrides(s2g(precision="fp32"), list(sopts)),
                                   len(sloader.dataset), dev)
    losses32, _ = train_step(state32, sbatches[0], plain=True)
    torch.cuda.synchronize()
    check(dict(kernels.LAUNCHES) == one_step, "the all-plain fp32 s2g step launched a kernel")
    l32 = {k: losses32[k].item() for k in l16}
    s_loss_rel = {k: abs(l16[k] - l32[k]) / abs(l32[k]) for k in l16}
    cos = torch.nn.functional.cosine_similarity
    s_cos = {"generator": cos(g16, flat_grads(state32.generator), dim=0).item(),
             "discriminator": cos(d16, flat_grads(state32.discriminator), dim=0).item()}
    # the BN generator's bf16 gradient sits at cosine ~0.8 from its fp32 one in
    # both packages (train-mode BN leaves each encoder conv's weight gradient a
    # small remainder of bf16-rounded terms: tests/test_torch_port_s2g_eval.py),
    # so its gate is 0.75; D's is 0.99, SDT-BP's gate
    check(all(r <= 0.02 for r in s_loss_rel.values()) and s_cos["discriminator"] >= 0.99
          and s_cos["generator"] >= 0.75,
          f"s2g bf16 step vs fp32 all-plain: losses {l16} vs {l32} (rel {s_loss_rel}), "
          f"gradient cosines {s_cos}")
    del state, state32, g16, d16

    lcfg = apply_overrides(s2g(), sopts + ["TRAIN.LR", "1e-3"])
    state = Voice2PoseTrainState(lcfg, len(sloader.dataset), dev)
    history, epoch = [], 0
    while len(history) < 30:
        epoch += 1
        sloader.batch_sampler.set_epoch(epoch)
        for b in sloader:
            step_losses, _ = train_step(state, b)
            history.append(torch.stack([v.float() for v in step_losses.values()]))
    torch.cuda.synchronize()
    s_train = dict(kernels.LAUNCHES)
    check(s_train.get("mel", 0) == 1 + len(history) and not any(in_kernels(s_train).values()),
          f"s2g train launches {s_train} over {1 + len(history)} kernel-path steps")
    report["mel"]["launches"] += s_train["mel"]
    hist = torch.stack(history).cpu()
    names = list(step_losses)
    check(bool(torch.isfinite(hist).all()), f"non-finite s2g losses: {hist}")
    reg = hist[:, names.index("G_reg_loss")].tolist()
    s_first4, s_last4 = sum(reg[:4]) / 4, sum(reg[-4:]) / 4
    check(s_last4 < s_first4, f"s2g G_reg_loss did not fall over {len(reg)} steps: first 4 "
                              f"mean {s_first4}, last 4 mean {s_last4}")
    s_step_ms = cuda_ms(lambda b: train_step(state, b), [(to_dev(b),) for b in sbatches], 20)
    print(f"[s2g-train] bf16 B={TB}: one step launched mel 1, conv1 0, stem 0; vs fp32 "
          f"all-plain: G_reg_loss rel {s_loss_rel['G_reg_loss']:.3e}, D_pose_gan_loss rel "
          f"{s_loss_rel['D_pose_gan_loss']:.3e} (<= 0.02), gradient cosine G "
          f"{s_cos['generator']:.6f} (>= 0.75), D {s_cos['discriminator']:.6f} (>= 0.99); "
          f"{len(reg)} steps at LR 1e-3: G_reg_loss first-4 mean {s_first4:.5f} -> last-4 "
          f"{s_last4:.5f}; step {s_step_ms:.4f} ms = {1e3 / s_step_ms:.2f} steps/s "
          f"(device-resident batches)", flush=True)
    del state, sbatches, sloader

    # (c) the graphed loop: phase 15's 1,600 clips staged on the card, global poses
    sgcfg = apply_overrides(s2g(), gopts + ["SYS.NUM_WORKERS", "8"])
    sgloader = train_loader(sgcfg, dev)
    cache_s2g, s_cache_line = stage_device_cache(sgcfg, sgloader, dev,
                                                 PIPELINES["Voice2Pose"].device_keys)
    check(cache_s2g is not None and "speaker_stat_global" in cache_s2g, s_cache_line)
    s_loops = {}
    for K in (1, 8):
        s_loops[K] = cached_loop(s2g, K, True, True, sgloader, cache_s2g)
        check(not any(in_kernels(s_loops[K].counts["launches"]).values()),
              f"s2g K={K} launched {s_loops[K].counts}")
        report["mel"]["launches"] += s_loops[K].counts["launches"]["mel"]
    k1, k8 = s_loops[1], s_loops[8]
    check(k8.graphs == [2, 8] and k8.counts["executed"].get("mel") == 100,
          f"s2g K=8: graphs {k8.graphs}, counts {k8.counts}")
    check(torch.equal(k8.rows, k1.rows),
          f"s2g: K=8 loss rows differ from K=1's: max abs {(k8.rows - k1.rows).abs().max()}")
    sd8, sd1 = k8.state.state_dict(), k1.state.state_dict()
    check(any(k.startswith("netD_pose.") for k in sd1) and all(torch.equal(sd8[k], sd1[k])
                                                                for k in sd1),
          "s2g: K=8 weights (D's included) differ from K=1's after 100 steps")
    print(f"[s2g-graphed] bf16 B={TB}, 1,600 clips on the card, two 50-step epochs: K=1 "
          f"capturable {k1.rates[1]:.2f} steps/s, K=8 {k8.rates[1]:.2f} steps/s "
          f"({1e3 / k8.rates[1]:.3f} ms; first epoch {k8.rates[0]:.2f}, captures included); "
          f"K=8 rows and weights (D's included) = K=1's bit for bit; K=8 counts {k8.counts}",
          flush=True)
    s_graph = {"k1_capturable_steps_per_s": k1.rates, "k8_steps_per_s": k8.rates,
               "k8_step_ms": 1e3 / k8.rates[1], "k8_counts": k8.counts,
               "k8_rows_equal_k1": True}
    del s_loops, k1, k8, cache_s2g, sgloader

    # (d) the command line: train with validation, test, resume, serve
    sruns = os.path.join(work, "s2g_runs")
    shutil.rmtree(sruns, ignore_errors=True)
    s2g_flags = ["--config_file", "configs/voice2pose_s2g.yaml"]
    s2g_common = [*sopts, "TEST.SAVE_VIDEO", "False", "SYS.OUTPUT_DIR", sruns,
                  "TRAIN.NUM_EPOCHS", "2", "TRAIN.VALIDATE", "True",
                  "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", ae_ckpt]
    t0 = time.perf_counter()
    c_s2g = main_cli(*s2g_flags, "--tag", "s2g", *s2g_common)
    check(c_s2g["steps"] == 4 and np.isfinite(c_s2g["val_metrics"]["FGD_mu"])
          and "D_pose_gan_loss" in c_s2g["losses"], f"s2g CLI line: {c_s2g}")
    c_s2g_test = main_cli(*s2g_flags, "--tag", "s2g_test", "--test_only", "--checkpoint",
                          c_s2g["checkpoint"], *s2g_common)
    check(all(np.isfinite(c_s2g_test["metrics"].get(k, np.nan)) for k in test_keys),
          f"s2g test CLI line: {c_s2g_test}")
    ck1 = glob.glob(os.path.join(c_s2g["output_dir"], "checkpoints", "checkpoint_epoch-1_*.pth"))
    check(len(ck1) == 1, f"s2g epoch-1 checkpoints: {ck1}")
    c_s2g_resumed = main_cli(*s2g_flags, "--tag", "s2g", "--resume_from", ck1[0], *s2g_common)
    check(c_s2g_resumed["steps"] == 4 and c_s2g_resumed["resumed_from"] == ck1[0],
          f"s2g resumed CLI line: {c_s2g_resumed}")
    s_served = os.path.join(work, "s2g_out.npz")
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.serving",
                        c_s2g_resumed["checkpoint"], wav_path, s_served, *s2g_flags,
                        "--device", "cuda"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"s2g serving CLI rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    with np.load(s_served) as z:
        got = z["poses"]
    check(got.shape == (64, 2, 121) and bool(np.isfinite(got).all()),
          f"poses served from the s2g checkpoint: {got.shape}")
    s_cli_s = time.perf_counter() - t0
    print(f"[s2g-cli] train 2 epochs with validation (FGD_mu "
          f"{c_s2g['val_metrics']['FGD_mu']:.4f}) -> --test_only "
          f"{ {k: round(c_s2g_test['metrics'][k], 4) for k in test_keys} } -> --resume_from "
          f"epoch 1 -> serving CLI: {r.stdout.strip()}; {s_cli_s:.1f} s", flush=True)
    s2g_line = {"s2g": {"card": card, "serve_ms_b128": s_fwd_ms,
                        "serve_pose_frames_per_s": 128 * 64 / (s_fwd_ms / 1e3),
                        "serve_rel_l2_vs_fp32_plain": s_rel, "serve_corr": s_corr,
                        "serve_launches": s_growth, "train_step_ms": s_step_ms,
                        "train_steps_per_s": 1e3 / s_step_ms,
                        "bf16_vs_fp32_loss_rel": s_loss_rel, "bf16_vs_fp32_grad_cos": s_cos,
                        "reg_loss_first4": s_first4, "reg_loss_last4": s_last4,
                        "train_launches": s_train, "graphed": s_graph,
                        "cli_test_metrics": c_s2g_test["metrics"], "cli_seconds": s_cli_s}}


    # ---- 17. the demo: dense, windowed, streaming, CLI -----------------------------
    from scipy.io import wavfile

    from speechdrivestemplates_tpu_torch.config import s2g as s2g_preset
    t17 = time.perf_counter()
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.ops.longform import window_audio
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.utils.audio import load_wav
    from speechdrivestemplates_tpu_torch.utils.streaming import StreamingPoseSession
    from speechdrivestemplates_tpu_torch.utils.weights import load_reference_pth

    def in_counts():
        """The kernels that ran since the counters were zeroed: eager launches and
        graph replays alike (a streaming session replays its window's graph)."""
        ran = kernels.executions()
        return {n: ran.get(n, 0) for n in ("mel", "conv1", "stem", "in_act")}

    # (a) the kernels at the demo's widest shapes, 24 s of audio: B1 on (1, 384000),
    # B3 on (1, 80, 2401), B2 on B3's (1, 82, 2401, 64) bf16 output
    DL = 384000
    DW1 = DL // 160 + 1
    d_audios = [dev_randn(1, DL, scale=0.1) for _ in range(3)]
    d_mel_err, d_quiet_rel, _ = check_mel(d_audios[0], f"demo clip (1, {DL})")
    report["mel"]["max_abs_err"] = max(report["mel"]["max_abs_err"], d_mel_err)
    d_mels = [M.mel_spectrogram_kernel(a) for a in d_audios]
    d_conv1_err = 0.0
    for kind, mel in (("normal", dev_randn(1, 80, DW1)), ("offset", dev_randn(1, 80, DW1) + 100)):
        ref1 = C1.conv1_in_plain(mel, w1, 0.2, torch.float32)
        k1 = C1.conv1_in_kernel(mel, w1, 0.2, torch.float32)
        k1b = C1.conv1_in_kernel(mel, w1, 0.2, bf)
        torch.cuda.synchronize()
        e = (k1 - ref1).abs().max().item()
        check(k1.shape == (1, C1.ROWS, DW1, 64) and torch.allclose(k1, ref1, rtol=2e-5, atol=2e-5),
              f"conv1 fp32 kernel vs plain at (1, 80, {DW1}), {kind} mel: max abs err {e}")
        check(all(not t[:, 0].any() and not t[:, -1].any() for t in (k1, k1b)),
              f"conv1 rows 0 and 81 are not zero at (1, 80, {DW1})")
        rel16 = ((k1b.float() - ref1).abs().mean() / ref1.abs().mean()).item()
        check(rel16 < 2e-2, f"conv1 bf16 kernel at (1, 80, {DW1}), {kind} mel: mean rel {rel16}")
        d_conv1_err = max(d_conv1_err, e)
    report["conv1"]["max_abs_err"] = max(report["conv1"]["max_abs_err"], d_conv1_err)
    ref32 = S.stem_plain(d_mels[0], w1, w2, w3, 0.2, torch.float32)
    k32 = S.stem_kernel(d_mels[0], w1, w2, w3, 0.2, torch.float32)
    k16 = S.stem_kernel(d_mels[0], w1, w2, w3, 0.2, bf).float()
    torch.cuda.synchronize()
    d_whole_err = (k32 - ref32).abs().max().item()
    check(k32.shape == (1, 40, S.stem_dims(DW1)[1], 128)
          and torch.allclose(k32, ref32, rtol=2e-4, atol=2e-5),
          f"stem fp32 kernels vs plain at (1, 80, {DW1}): max abs err {d_whole_err}")
    e16 = (k16 - ref32).abs().flatten()
    d_q99 = torch.quantile(e16[:: max(1, e16.numel() // 4_000_000)], 0.99).item()
    check(d_q99 < 0.05 and e16.mean().item() < 0.02,
          f"stem bf16 kernels vs fp32 plain at (1, 80, {DW1}): p99 {d_q99}")
    d_y1s = [C1.conv1_in_kernel(m, w1, 0.2, bf) for m in d_mels]
    t16 = S.stem_tail_kernel(d_y1s[0], w2, w3, 0.2, bf).float()
    tref = S.stem_tail_plain(d_y1s[0], w2, w3, 0.2, bf).float()
    torch.cuda.synchronize()
    e16 = (t16 - tref).abs().flatten()
    d_stem_err = e16.max().item()
    d_tail_q99 = torch.quantile(e16[:: max(1, e16.numel() // 4_000_000)], 0.99).item()
    check(d_tail_q99 < 0.05 and e16.mean().item() < 0.02 and d_stem_err < 0.1,
          f"stem kernel bf16 vs plain bf16 at (1, 82, {DW1}, 64): p99 {d_tail_q99}, "
          f"mean {e16.mean().item()}, max {d_stem_err}")
    report["stem"]["max_abs_err"] = max(report["stem"]["max_abs_err"], d_stem_err)
    DH2, DW2 = S.stem_dims(DW1)
    d_bounds = {  # as the kernels line's bounds, at the 24 s shapes
        "mel": bound_ms(4.0 * (DL + 80 * DW1), 3 * 2.0 * DW1 * (400 * 512 + 256 * 80), "bf16"),
        "conv1": bound_ms(4.0 * 80 * DW1 + 4.0 * w1.numel() + 2.0 * C1.ROWS * DW1 * 64,
                          2.0 * 80 * DW1 * 64 * 9, "fp32"),
        "stem": bound_ms(2.0 * 80 * DW1 * 64 + 2.0 * (w2.numel() + w3.numel())
                         + 2.0 * DH2 * DW2 * 128,
                         2.0 * DH2 * DW2 * (64 * 64 * 16 + 128 * 64 * 9), "bf16")}
    demo_kernels = {
        "mel_1x384000": {"ms": cuda_ms(M.mel_spectrogram_kernel, [(a,) for a in d_audios]),
                         "plain_ms": cuda_ms(M.mel_spectrogram_plain, [(a,) for a in d_audios]),
                         "max_abs_err": d_mel_err, "quiet_max_rel_err": d_quiet_rel,
                         "bound_ms": d_bounds["mel"][0], "bound_by": d_bounds["mel"][1]},
        "conv1_1x80x2401": {"ms": cuda_ms(C1.conv1_in_kernel, [(m, w1, 0.2, bf) for m in d_mels]),
                            "plain_ms": cuda_ms(C1.conv1_in_plain,
                                                [(m, w1, 0.2, bf) for m in d_mels], 5),
                            "max_abs_err": d_conv1_err, "bound_ms": d_bounds["conv1"][0],
                            "bound_by": d_bounds["conv1"][1]},
        "stem_1x82x2401x64": {"ms": cuda_ms(S.stem_tail_kernel,
                                            [(y, w2, w3, 0.2, bf) for y in d_y1s], 10),
                              "plain_ms": cuda_ms(S.stem_tail_plain,
                                                  [(y, w2, w3, 0.2, bf) for y in d_y1s], 10),
                              "max_abs_err": d_stem_err, "fp32_whole_max_abs_err": d_whole_err,
                              "bf16_vs_fp32_p99": d_q99, "bf16_tail_p99": d_tail_q99,
                              "bound_ms": d_bounds["stem"][0], "bound_by": d_bounds["stem"][1]}}
    print(f"[demo-kernels] {card}: mel kernel at (1, {DL}) max abs err {d_mel_err:.3e}, quiet "
          f"half max rel {d_quiet_rel:.3e}, {demo_kernels['mel_1x384000']['ms']:.4f} ms (plain "
          f"{demo_kernels['mel_1x384000']['plain_ms']:.4f}); conv1 at (1, 80, {DW1}) fp32 max "
          f"abs err {d_conv1_err:.3e} (normal and offset mels), bf16 "
          f"{demo_kernels['conv1_1x80x2401']['ms']:.4f} ms (plain "
          f"{demo_kernels['conv1_1x80x2401']['plain_ms']:.4f}); stem at (1, 82, {DW1}, 64): "
          f"fp32 kernels max abs err {d_whole_err:.3e}, bf16 vs fp32 p99 {d_q99:.4f}, bf16 vs "
          f"plain bf16 max {d_stem_err:.3e} p99 {d_tail_q99:.4f}, "
          f"{demo_kernels['stem_1x82x2401x64']['ms']:.4f} ms (plain "
          f"{demo_kernels['stem_1x82x2401x64']['plain_ms']:.4f})", flush=True)
    del d_audios, d_mels, d_y1s, ref32, k32, k16, t16, tref, e16

    # (b) the dense demo of phase 11's SDT-BP checkpoint, bf16, on three clips
    demo_dir = os.path.join(work, "demo")
    shutil.rmtree(demo_dir, ignore_errors=True)
    os.makedirs(os.path.join(demo_dir, "wavs"))

    def write_wav(path, seconds, sr=16000, seed=0, dtype="int16"):
        r = np.random.RandomState(seed)
        t = np.arange(int(seconds * sr)) / sr
        x = (0.1 * np.sin(2 * np.pi * (140 + 20 * seed) * t) * (1 + np.sin(2 * np.pi * 2.5 * t))
             + 0.05 * r.randn(len(t)))
        wavfile.write(path, sr, (x * 32767).astype(np.int16) if dtype == "int16"
                      else x.astype(np.float32))
        return path

    clips = {s: write_wav(os.path.join(demo_dir, f"clip_{s}.wav"), s, seed=i)
             for i, s in enumerate((4.27, 10.3, 24.0))}
    dopts = ["TEST.SAVE_VIDEO", "False", "DEMO.CODE_INDEX", "0"]

    def demo_state(precision="bf16", *extra):
        st = Voice2PoseTrainState(apply_overrides(sdt_bp(precision=precision),
                                                  [*dopts, *extra]), None, dev)
        st.load_pth(ckpt)
        return st

    def demo_batch(path):
        return collate([GestureDataset("unused", "oliver", sdt_bp(), split="demo",
                                       demo_input=path)[0]])

    batches = {s: demo_batch(p) for s, p in clips.items()}
    frames = {s: int(b["num_frames"][0]) for s, b in batches.items()}
    check(frames == {4.27: 64, 10.3: 154, 24.0: 360}, f"demo clip frames {frames}")

    def motion_rel(got, ref, batch):
        """rel L2 and correlation of pixel-space poses, both taken about the
        speaker's mean pose (the final poses of a zero prediction), so that the
        shared mean does not hide an error of the motion."""
        stat = {k: v.to(dev) for k, v in batch["speaker_stat"].items()}
        base = get_final_results(torch.zeros_like(ref), stat["mean"], stat["std"],
                                 stat["scale_factor"], True, 121)
        a, b = (got - base).double(), (ref - base).double()
        rel = (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
        corr = torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1].item()
        return rel, corr

    def motion_gate(got, ref, batch, what, rel_max=0.05):
        rel, corr = motion_rel(got, ref, batch)
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and rel < rel_max
              and corr > 0.999, f"{what}: shape {tuple(got.shape)}, rel L2 {rel} (gate "
                                f"{rel_max}), corr {corr}")
        return rel, corr

    def timed(fn, reps):
        """Host ms per call, the card synchronized, after one warm-up call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    routes, demo_launches = {}, collections.Counter()
    held = collections.defaultdict(list)  # the kernels against plain at the routes' shapes

    def record(route, sec, ms, **kw):
        routes.setdefault(route, {})[f"{sec}s"] = dict(ms_per_clip=ms, real_time_factor=sec / (
            ms / 1e3), **kw)

    def hold_route_kernels(audio, sw, what):
        """B1, B3 and B2 once each on a route's own input (``audio`` as the
        route feeds B1, its mel, conv1's bf16 output), against their plain
        versions with phases 3-5's gates; ``sw``, the generator's stem weights.
        Outside the counted runs."""
        w1_, w2_, w3_ = (w.detach() for w in sw)
        e_mel, _, _ = check_mel(audio, what)
        mel = M.mel_spectrogram_kernel(audio)
        k1 = C1.conv1_in_kernel(mel, w1_, 0.2, torch.float32)
        ref1 = C1.conv1_in_plain(mel, w1_, 0.2, torch.float32)
        y1 = C1.conv1_in_kernel(mel, w1_, 0.2, bf)
        tk = S.stem_tail_kernel(y1, w2_, w3_, 0.2, bf).float()
        tp = S.stem_tail_plain(y1, w2_, w3_, 0.2, bf).float()
        t32 = S.stem_tail_plain(y1.float(), w2_, w3_, 0.2, torch.float32)
        torch.cuda.synchronize()
        e1 = (k1 - ref1).abs().max().item()
        check(torch.allclose(k1, ref1, rtol=2e-5, atol=2e-5),
              f"conv1 fp32 kernel vs plain on {what}, mel {tuple(mel.shape)}: max abs err {e1}")
        rel16 = ((y1.float() - ref1).abs().mean() / ref1.abs().mean()).item()
        check(rel16 < 2e-2, f"conv1 bf16 kernel on {what}: mean rel {rel16}")
        e = (tk - tp).abs().flatten()
        q99 = torch.quantile(e[:: max(1, e.numel() // 4_000_000)], 0.99).item()
        # phase 5's max gate (0.1) is a few bf16 ulps of O(1) values; a real clip's
        # post-IN values reach 8-19, where one ulp is 0.0625-0.125, and both bf16
        # versions part from the fp32 one by 0.13-0.19 there, the kernel's worst
        # element 0.92-1.34x the plain bf16 version's (PERF.md): the kernel's
        # largest distance from fp32 is held within twice the plain bf16 one's
        k_far, p_far = (tk - t32).abs().max().item(), (tp - t32).abs().max().item()
        check(q99 < 0.05 and e.mean().item() < 0.02 and k_far <= 2.0 * p_far,
              f"stem kernel bf16 vs plain bf16 on {what}, {tuple(y1.shape)}: p99 {q99}, "
              f"mean {e.mean().item()}, max {e.max().item()}; max from fp32: kernel {k_far}, "
              f"plain bf16 {p_far}")
        held["stem_far_from_fp32_kernel_vs_plain"].append((k_far, p_far))
        held["shapes"].append(f"{what}: audio {tuple(audio.shape)}, y1 {tuple(y1.shape)}")
        for n, v in (("mel", e_mel), ("conv1", e1), ("stem", e.max().item())):
            report[n]["max_abs_err"] = max(report[n]["max_abs_err"], v)
            held[f"{n}_max_abs_err"].append(v)

    # DEMO.LENGTH_BUCKET_S is read and ignored: the default (2.0) and 0 give one route
    dense, dense0 = demo_state("bf16"), demo_state("bf16", "DEMO.LENGTH_BUCKET_S", "0")
    dense32 = demo_state("fp32")
    stem_w = [dense.generator.audio_encoder.layers()[i].conv.weight for i in range(3)]
    for sec, b in batches.items():
        kernels.reset_launch_counts()
        out = V2P.demo_step(dense, b)["poses_pred_batch"]
        torch.cuda.synchronize()
        n_dense = in_counts()
        check(n_dense == {"mel": 1, "conv1": 1, "stem": 1, "in_act": 21},
              f"dense demo of {sec} s launched {n_dense}")
        demo_launches.update(n_dense)
        check(torch.equal(out, V2P.demo_step(dense0, b)["poses_pred_batch"]),
              f"dense demo of {sec} s: DEMO.LENGTH_BUCKET_S 2.0 and 0 differ")
        with torch.inference_mode():
            ref = V2P.demo_step(dense32, b, plain=True)["poses_pred_batch"]
        gate = motion_gate(out, ref, b, f"dense demo of {sec} s vs fp32 plain")
        check(out.shape == (1, frames[sec], 2, 121), f"demo poses {out.shape}")
        hold_route_kernels(b["audio"].to(dev), stem_w, f"the dense demo's {sec} s clip")
        record("dense", sec, timed(lambda: V2P.demo_step(dense, b), 5),
               rel_l2_vs_fp32_plain=gate[0], corr=gate[1])
        print(f"[demo-dense] {sec} s ({frames[sec]} frames): launched {n_dense}, vs fp32 plain "
              f"rel L2 {gate[0]:.4e} corr {gate[1]:.6f}, DEMO.LENGTH_BUCKET_S 2.0 = 0 bit for "
              f"bit; {routes['dense'][f'{sec}s']['ms_per_clip']:.3f} ms a clip", flush=True)
    del dense32, dense0

    # (c) windowed and streaming on the 10.3 s and 24 s clips
    windowed = demo_state("bf16", "DEMO.WINDOWED", "True")
    windowed32 = demo_state("fp32", "DEMO.WINDOWED", "True")
    fn, _ = build_serving_fn(windowed.cfg, load_reference_pth(ckpt), device="cuda")
    code = windowed.clips_code[0:1].detach()
    # streaming runs B = 1 windows, the windowed demo one B = n batch: cuDNN may pick
    # other algorithms for the two batch sizes, so the two bf16 forwards round
    # otherwise. Runs on the H100 read rel L2 2.4e-3 and 5.3e-3 (PERF.md); a session whose
    # crossfade differs (halo 8 frames against the demo's 16) must read above the gate
    STREAM_REL_L2 = 2e-2
    stream_gate = {}

    def stream(audio, halo=16):
        sess = StreamingPoseSession(lambda a: fn(a, code).float().cpu().numpy(),
                                    halo_frames=halo)
        got = [sess.feed(audio[i: i + 8000]) for i in range(0, len(audio), 8000)]
        return np.concatenate([g for g in got + [sess.flush()] if g.size])

    for sec in (10.3, 24.0):
        b = batches[sec]
        n_win = -(-(frames[sec] - 64) // 32) + 1
        kernels.reset_launch_counts()
        out_win = V2P.demo_step(windowed, b)["poses_pred_batch"].to(dev)
        torch.cuda.synchronize()
        n = in_counts()
        check(n == {"mel": 1, "conv1": 1, "stem": 1, "in_act": 21},
              f"windowed demo of {sec} s ({n_win} windows) launched {n}")
        demo_launches.update(n)
        with torch.inference_mode():
            ref = V2P.demo_step(windowed32, b, plain=True)["poses_pred_batch"].to(dev)
        gate_win = motion_gate(out_win, ref, b, f"windowed demo of {sec} s vs fp32 plain")
        windows, _ = window_audio(np.asarray(b["audio"][0]), frames[sec], 64, 16)
        check(len(windows) == n_win, f"{sec} s: {len(windows)} windows, expected {n_win}")
        hold_route_kernels(torch.from_numpy(windows).to(dev), stem_w,
                           f"the windowed demo's {n_win} windows of {sec} s")
        record("windowed", sec, timed(lambda: V2P.demo_step(windowed, b), 5), windows=n_win,
               rel_l2_vs_fp32_plain=gate_win[0], corr=gate_win[1])

        # the wav's own samples: the item's audio is snapped to whole frames,
        # and parse_audio_length of a snapped length can give one frame less
        audio = load_wav(clips[sec])
        kernels.reset_launch_counts()
        streamed = torch.from_numpy(stream(audio))[None].to(dev)
        n = in_counts()
        check(n == {"mel": n_win, "conv1": n_win, "stem": n_win, "in_act": 21 * n_win},
              f"streaming {sec} s in 0.5 s chunks ({n_win} windows) ran {n}")
        demo_launches.update(n)
        s_rel, s_corr = motion_gate(streamed, out_win, b, f"streaming {sec} s vs windowed",
                                    STREAM_REL_L2)
        s_max = (streamed - out_win).abs().max().item()
        stream_gate[f"{sec}s"] = dict(rel_l2=s_rel, corr=s_corr, max_abs_px=s_max,
                                      bit_identical=bool(torch.equal(streamed, out_win)),
                                      gate_rel_l2=STREAM_REL_L2)
        if sec == 24.0:  # the gate sees a crossfade fault: halo 8 frames, not 16
            hold_route_kernels(torch.from_numpy(windows[:1]).to(dev), stem_w,
                               "a streaming window (B = 1)")
            bad = torch.from_numpy(stream(audio, halo=8))[None].to(dev)
            bad_rel = motion_rel(bad, out_win, b)[0]
            check(bad.shape == out_win.shape and bad_rel > STREAM_REL_L2,
                  f"a halo-8 session vs the windowed demo reads rel L2 {bad_rel}, within the "
                  f"streaming gate {STREAM_REL_L2}")
            stream_gate["planted_halo8_rel_l2"] = bad_rel
        record("streaming", sec, timed(lambda: stream(audio), 2), windows=n_win, chunk_s=0.5,
               **stream_gate[f"{sec}s"])
        print(f"[demo-windowed] {sec} s: {n_win} windows in one batch launched mel 1, conv1 1, "
              f"stem 1, in_act 21, vs fp32 plain rel L2 {gate_win[0]:.4e} corr {gate_win[1]:.6f}, "
              f"{routes['windowed'][f'{sec}s']['ms_per_clip']:.3f} ms; streaming in 0.5 s "
              f"chunks launched {n_win} each, vs windowed rel L2 {s_rel:.3e} (gate "
              f"{STREAM_REL_L2}) corr {s_corr:.6f}, max {s_max:.3e} px, bit for bit "
              f"{stream_gate[f'{sec}s']['bit_identical']}, "
              f"{routes['streaming'][f'{sec}s']['ms_per_clip']:.3f} ms", flush=True)
    print(f"[demo-held] {card}: the kernels against plain on the routes' own inputs: "
          f"{held['shapes']}; max abs err mel {max(held['mel_max_abs_err']):.3e}, conv1 "
          f"{max(held['conv1_max_abs_err']):.3e}, stem {max(held['stem_max_abs_err']):.3e}; "
          f"a halo-8 session reads rel L2 {stream_gate['planted_halo8_rel_l2']:.4e}",
          flush=True)
    del windowed, windowed32, dense, fn
    for name, n in demo_launches.items():
        report[name]["launches"] += n

    # (d) the command line on a directory (SDT-BP); then s2g, SDT-VAE and Pose2Pose
    # through trainer.demo, the function the command line calls, in this process
    # (a process costs the demo's time many times over in start-up)
    wav_dir = os.path.join(demo_dir, "wavs")
    for i, (sec, sr, dtype) in enumerate([(3.0, 16000, "int16"), (5.1, 44100, "float32"),
                                          (6.9, 16000, "int16")]):
        write_wav(os.path.join(wav_dir, f"talk{i}.wav"), sec, sr, 10 + i, dtype)
    druns = os.path.join(demo_dir, "runs")
    t0 = time.perf_counter()

    def check_archives(out, n, what):
        check(len(out["npz"]) == n, f"{what}: {out}")
        for p in out["npz"]:
            with np.load(p) as z:
                poses = z["poses_pred_batch"]
            check(poses.ndim == 4 and poses.shape[0] == 1 and poses.shape[2:] == (2, 121)
                  and bool(np.isfinite(poses).all()), f"{what} archive {p}: {poses.shape}")

    c_demo = main_cli("--tag", "demo_bp", "--demo_input", wav_dir, "--checkpoint", ckpt,
                      "SYS.OUTPUT_DIR", druns, "TEST.SAVE_VIDEO", "False", "DEMO.MULTIPLE", "3",
                      "DEMO.CODE_INDEX", "0", "DEMO.CODE_INDEX_B", "1", "DEMO.NUM_SAMPLES", "3")
    check_archives(c_demo, 9, "SDT-BP demo CLI")
    check(sorted(c_demo["num_frames"]) == [64, 76, 103]
          and sorted(os.path.basename(p) for p in c_demo["npz"])
          == [f"epoch0-DEMO-step{t}-{i}.npz" for t in (1, 2, 3) for i in range(3)],
          f"SDT-BP demo CLI line: {c_demo}")
    demo_cli_s = time.perf_counter() - t0
    from speechdrivestemplates_tpu_torch.config import sdt_vae

    code_path = os.path.join(demo_dir, "codes.npz")
    np.savez(code_path, v=rng.randn(2, 32))
    common_demo = ["SYS.OUTPUT_DIR", druns, "TEST.SAVE_VIDEO", "False"]
    d_s2g = trainer.demo(apply_overrides(s2g_preset(), list(common_demo)),
                         c_s2g_resumed["checkpoint"], clips[10.3], "demo_s2g", dev)
    check_archives(d_s2g, 1, "s2g demo")
    with np.load(d_s2g["npz"][0]) as z:
        check(z["poses_pred_batch"].shape == (1, frames[10.3], 2, 121)
              and "condition_code" not in z.files, f"s2g demo archive: {z.files}")
    d_vae = trainer.demo(apply_overrides(sdt_vae(), [*common_demo,
                                                     "VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT",
                                                     ae_chain]),
                         c_vae["checkpoint"], clips[4.27], "demo_vae", dev)
    check_archives(d_vae, 1, "SDT-VAE demo")
    d_p2p = trainer.demo(apply_overrides(pose2pose(), [*common_demo, "DEMO.CODE_PATH", code_path,
                                                       "DEMO.MULTIPLE", "2"]),
                         ae_chain, clips[4.27], "demo_p2p", dev)
    check_archives(d_p2p, 2, "Pose2Pose demo")
    demo_fn_s = time.perf_counter() - t0 - demo_cli_s
    print(f"[demo-cli] SDT-BP through the command line on a directory of 3 wavs (one 44.1 kHz "
          f"float) x 3 codes: 9 archives of {sorted(c_demo['num_frames'])} frames, "
          f"{demo_cli_s:.1f} s; trainer.demo of s2g on 10.3 s, SDT-VAE on 4.27 s, Pose2Pose "
          f"decoding DEMO.CODE_PATH x 2: {demo_fn_s:.1f} s", flush=True)

    # (e) what the video slice will need on this host (facts, not gates)
    demo_line = {"demo": {"card": card, "routes": routes, "kernels_at_24s": demo_kernels,
                          "kernels_on_route_inputs": dict(held),
                          "streaming_vs_windowed": stream_gate,
                          "launches": dict(demo_launches), "cli_seconds": demo_cli_s,
                          "trainer_demo_seconds": demo_fn_s,
                          "cv2_importable": subprocess.run(
                              [sys.executable, "-c", "import cv2"], capture_output=True,
                              timeout=120).returncode == 0,
                          "ffmpeg_on_path": shutil.which("ffmpeg") is not None}}
    demo_line["demo"]["phase_seconds"] = time.perf_counter() - t17
    print(f"[demo] cv2 importable: {demo_line['demo']['cv2_importable']}; ffmpeg on PATH: "
          f"{demo_line['demo']['ffmpeg_on_path']}; phase 17 took "
          f"{demo_line['demo']['phase_seconds']:.1f} s", flush=True)

    # ---- 18. the serving export: main --export, the artifact, the runner -------------
    from speechdrivestemplates_tpu_torch.utils.export import (export_serving_fn, graph_ops,
                                                              load_serving_fn)

    t18 = time.perf_counter()
    exp_dir = os.path.join(work, "export")
    shutil.rmtree(exp_dir, ignore_errors=True)
    os.makedirs(exp_dir)
    bp_ops = {"sdt.conv1_in": 1, "sdt.in_act": 21, "sdt.mel": 1, "sdt.stem": 1}
    p18 = collections.Counter()  # the main path's launches: the three runs below alone

    def main_path(call):
        """``call()`` with the counters zeroed just before it, read just after;
        its launches are added to phase 18's count. The reference calls, the
        warm-ups and the timed calls around it are not counted."""
        kernels.reset_launch_counts()
        out = call()
        torch.cuda.synchronize()
        n = dict(kernels.LAUNCHES)
        p18.update(n)
        return out, n

    def rel_l2(got, ref):
        return (torch.linalg.norm((got - ref).double()) / torch.linalg.norm(ref.double())).item()

    # (a) main --export of phase 11's checkpoint with the default preset (SDT-BP,
    # bf16), as the serving command line serves it, at B = 1 and B = 128
    arts, export_s, art_bytes = {}, {}, {}
    for eb in (1, 128):
        arts[eb] = os.path.join(exp_dir, f"sdt_bp_b{eb}.pt2")
        t0 = time.perf_counter()
        side = main_cli("--export", arts[eb], "--export_batch", str(eb), "--checkpoint", ckpt)
        export_s[f"sdt_bp_b{eb}_cli_process"] = time.perf_counter() - t0
        art_bytes[f"sdt_bp_b{eb}"] = side["bytes"]
        check(side["ops"] == bp_ops and side["device"] == "cuda" and side["batch_size"] == eb
              and side["bytes"] == os.path.getsize(arts[eb]), f"--export B={eb}: {side}")
        graph = graph_ops(torch.export.load(arts[eb]))
        check(graph == bp_ops, f"the B={eb} artifact's graph calls {graph}, expected {bp_ops}")

    # (b) the B = 128 artifact in this process against build_serving_fn
    t0 = time.perf_counter()
    art = load_serving_fn(arts[128])
    load_s = {"sdt_bp_b128": time.perf_counter() - t0}
    fn, _ = build_serving_fn(sdt_bp(), load_reference_pth(ckpt), device="cuda")
    audio, code = dev_randn(128, L, scale=0.1), dev_randn(128, 32)
    got, n = main_path(lambda: art(audio, code))
    check(n == {"mel": 1, "conv1": 1, "stem": 1, "in_act": 21},
          f"one call of the B=128 artifact launched {n}")
    ref = fn(audio, code)
    art_rel = rel_l2(got, ref)
    art_equal = bool(torch.equal(got, ref))
    check(got.shape == (128, 64, 2, 121) and art_equal,
          f"B=128 artifact vs build_serving_fn: rel L2 {art_rel}, not bit for bit")
    art_ms = cuda_ms(art, [(audio, code)], 20)
    print(f"[export] main --export of phase 11's checkpoint, B=1 and 128: graphs call {bp_ops}, "
          f"{art_bytes} bytes, {export_s} s; B=128 loaded in {load_s['sdt_bp_b128']:.2f} s, one "
          f"call launched {n}, vs build_serving_fn rel L2 {art_rel:.3e} (bit for bit "
          f"{art_equal}), {art_ms:.4f} ms a call (build_serving_fn {fwd_ms:.4f} ms in phase 7)",
          flush=True)

    # (c) the runner on phase 8's wav with the B = 1 artifact, against phase 11's
    # serving command line on the same wav and code seed (0)
    runner = os.path.join(ROOT, "speechdrivestemplates_tpu_torch", "run_artifact.py")

    def run_runner(*args):
        r = subprocess.run([sys.executable, runner, *args], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        check(r.returncode == 0, f"run_artifact {args} rc {r.returncode}:\n{r.stdout}\n"
                                 f"{r.stderr[-4000:]}")
        return r.stdout.strip().splitlines()

    r_out = os.path.join(exp_dir, "runner_b1.npz")
    t0 = time.perf_counter()
    run_runner(arts[1], wav_path, r_out, "--code-seed", "0")
    runner_s = time.perf_counter() - t0
    with np.load(r_out) as z, np.load(served) as s:
        r_got, r_ref = torch.from_numpy(z["poses"]), torch.from_numpy(s["poses"])
    runner_rel = rel_l2(r_got, r_ref)
    runner_equal = bool(torch.equal(r_got, r_ref))
    check(r_got.shape == (64, 2, 121) and runner_rel < 1e-3,
          f"runner vs the serving command line: rel L2 {runner_rel}")

    # (d) --bench 20 at B = 128
    bench = json.loads(run_runner(arts[128], wav_path, os.path.join(exp_dir, "runner_b128.npz"),
                                  "--bench", "20")[-1])
    check(bench["batch"] == 128 and bench["value"] > 0 and bench["per_call_ms"] > 0,
          f"runner --bench: {bench}")
    print(f"[export-runner] run_artifact.py B=1 on phase 8's wav = the serving CLI: rel L2 "
          f"{runner_rel:.3e}, bit for bit {runner_equal} ({runner_s:.1f} s with its process); "
          f"--bench 20 at B=128: {bench['per_call_ms']:.4f} ms a call, {bench['value']:.1f} "
          f"frames/s (phase 7's forward {fwd_ms:.4f} ms, {128 * 64 / (fwd_ms / 1e3):.1f})",
          flush=True)

    # (e) s2g: phase 16's checkpoint exported in this process, B = 16
    s_art_path = os.path.join(exp_dir, "s2g_b16.pt2")
    t0 = time.perf_counter()
    s_meta = export_serving_fn(s2g_preset(), c_s2g_resumed["checkpoint"], s_art_path,
                               batch_size=16)
    export_s["s2g_b16_in_process"] = time.perf_counter() - t0
    art_bytes["s2g_b16"] = s_meta["bytes"]
    graph = graph_ops(torch.export.load(s_art_path))
    check(s_meta["ops"] == graph == {"sdt.bn_act": 24, "sdt.mel": 1}
          and s_meta["code_dim"] is None, f"s2g export: sidecar {s_meta}, graph {graph}")
    t0 = time.perf_counter()
    s_art = load_serving_fn(s_art_path)
    load_s["s2g_b16"] = time.perf_counter() - t0
    s_fn, _ = build_serving_fn(s2g_preset(), load_reference_pth(c_s2g_resumed["checkpoint"]),
                               device="cuda")
    a16 = dev_randn(16, L, scale=0.1)
    got, n = main_path(lambda: s_art(a16))
    check(n == {"mel": 1, "bn_act": 24}, f"one call of the s2g artifact launched {n}")
    ref = s_fn(a16)
    s_art_rel, s_art_equal = rel_l2(got, ref), bool(torch.equal(got, ref))
    check(got.shape == (16, 64, 2, 121) and s_art_rel < 1e-3,
          f"s2g artifact vs build_serving_fn: rel L2 {s_art_rel}")

    # (g) streaming off a B = 1 artifact at the window's length, held to phase 17's
    # windowed demo of the 24 s clip at phase 17's gate
    w_art_path = os.path.join(exp_dir, "sdt_bp_window.pt2")
    w_meta = export_serving_fn(sdt_bp(), ckpt, w_art_path, audio_length=68266)
    w_art = load_serving_fn(w_art_path)
    windowed = demo_state("bf16", "DEMO.WINDOWED", "True")
    w_code = windowed.clips_code[0:1].detach()
    b = batches[24.0]
    out_win = V2P.demo_step(windowed, b)["poses_pred_batch"].to(dev)
    audio24 = load_wav(clips[24.0])

    def stream_off_artifact():
        sess = StreamingPoseSession(lambda a: w_art(a, w_code).float().cpu().numpy())
        got = [sess.feed(audio24[i: i + 8000]) for i in range(0, len(audio24), 8000)]
        return torch.from_numpy(np.concatenate([g for g in got + [sess.flush()] if g.size]))

    streamed, n = main_path(stream_off_artifact)
    check(n == {"mel": 11, "conv1": 11, "stem": 11, "in_act": 11 * 21},
          f"streaming 24 s off the window artifact launched {n} (11 windows)")
    a_rel, a_corr = motion_gate(streamed[None].to(dev), out_win, b,
                                "streaming 24 s off the window artifact vs windowed",
                                STREAM_REL_L2)
    del art, s_art, w_art, fn, s_fn, windowed
    for name, v in p18.items():
        report[name]["launches"] += v
    export_line = {"export": {
        "card": card, "export_seconds": export_s, "load_seconds": load_s, "bytes": art_bytes,
        "window_artifact_bytes": w_meta["bytes"], "graph_ops_sdt_bp": bp_ops,
        "artifact_vs_build_serving_fn_b128": {"rel_l2": art_rel, "bit_identical": art_equal},
        "artifact_ms_b128": art_ms, "phase7_forward_ms_b128": fwd_ms,
        "runner_vs_serving_cli_b1": {"rel_l2": runner_rel, "bit_identical": runner_equal},
        "runner_b1_seconds_with_process": runner_s, "runner_bench_b128": bench,
        "s2g_vs_build_serving_fn_b16": {"rel_l2": s_art_rel, "bit_identical": s_art_equal},
        "streaming_artifact_vs_windowed_24s": {"rel_l2": a_rel, "corr": a_corr,
                                               "gate_rel_l2": STREAM_REL_L2},
        "launches": dict(p18), "phase_seconds": time.perf_counter() - t18}}
    print(f"[export-s2g] s2g B=16 exported in {export_s['s2g_b16_in_process']:.2f} s, graph "
          f"{graph}, vs build_serving_fn rel L2 {s_art_rel:.3e} (bit for bit {s_art_equal}); "
          f"streaming 24 s off a B=1 window artifact vs the windowed demo: rel L2 {a_rel:.3e} "
          f"(gate {STREAM_REL_L2}), corr {a_corr:.6f}; phase 18 launched {dict(p18)} and took "
          f"{export_line['export']['phase_seconds']:.1f} s", flush=True)

    # ---- 19. video: pose videos, TensorBoard videos and the epoch figure ------------
    import cv2

    from speechdrivestemplates_tpu_torch import main as port_main
    from speechdrivestemplates_tpu_torch.utils import tb_native
    from speechdrivestemplates_tpu_torch.utils.video import VideoWriter

    t19 = time.perf_counter()
    vdir = os.path.join(work, "video")
    shutil.rmtree(vdir, ignore_errors=True)
    # (a) facts of this host, not gates
    try:
        import matplotlib
        mpl_version = matplotlib.__version__
    except ImportError:
        mpl_version = None
    facts = {"matplotlib": mpl_version, "cv2": cv2.__version__,
             "ffmpeg_on_path": shutil.which("ffmpeg") is not None}
    p19 = collections.Counter()
    bp_file = os.path.join(ROOT, "configs", "voice2pose_sdt_bp.yaml")

    def cli(*args):
        """``main`` as the command line calls it, in this process (its launches
        are counted here)."""
        kernels.reset_launch_counts()
        out = port_main.main(["--device", "cuda", "--tag", "video", *args])
        torch.cuda.synchronize()
        return out, in_counts()

    def read_mp4(path):
        cap = cv2.VideoCapture(path)
        got = []
        while True:
            ok, f = cap.read()
            if not ok:
                cap.release()
                return np.stack(got) if got else np.zeros((0, 0, 0, 3), np.uint8)
            got.append(f)

    def drawn_mad(video, drawn):
        """Mean absolute difference over the pixels that either frame draws
        on (any channel below 250 of the white canvas), frame by frame."""
        total = count = 0
        for a, b in zip(video, drawn):
            mask = (a.min(-1) < 250) | (b.min(-1) < 250)
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))[mask]
            total, count = total + int(d.sum()), count + d.size
        return total / count

    def events_of(run_dir):
        return tb_native.read_events(glob.glob(os.path.join(run_dir, "events.*"))[0])

    # (b) the demo through the command line on the 4.27 and 10.3 s clips, mp4 + jpg
    vcfg = apply_overrides(sdt_bp(), [])  # the canvas and scaling the run draws with
    MAD_GATE = 24.0  # mp4v on the white 720x1280 canvas: ~4-8 on its own poses, ~60 on others
    d19, n = cli("--config_file", bp_file, "--demo_input", f"{clips[4.27]} {clips[10.3]}",
                 "--checkpoint", ckpt, "SYS.OUTPUT_DIR", os.path.join(vdir, "demo"),
                 "TEST.SAVE_VIDEO", "True", "SYS.VIDEO_FORMAT", "['mp4', 'img']")
    check(n == {"mel": 2, "conv1": 2, "stem": 2, "in_act": 2 * 21},
          f"the video demo of 2 clips launched {n}: mel, conv1, stem once a clip, in_act 21")
    p19.update(n)
    check(os.path.basename(d19["output_dir"]).endswith("_voice2pose_sdt_bp-DEMO-video")
          and d19["num_frames"] == [frames[4.27], frames[10.3]] == [64, 154],
          f"video demo line {d19}")
    demo_video, drawn = {}, {}
    for t, sec in ((1, 4.27), (2, 10.3)):
        stem_ = f"epoch0-DEMO-step{t}"
        names = [os.path.join(d19["output_dir"], "videos", stem_ + ".mp4"),
                 os.path.join(d19["output_dir"], "videos", stem_ + ".wav"),
                 os.path.join(d19["output_dir"], "imgs", stem_ + ".jpg")]
        check(all(os.path.exists(f) for f in names), f"demo video files of step {t}: {names}")
        vid = read_mp4(names[0])
        check(vid.shape == (frames[sec], 720, 1280, 3),
              f"{stem_}.mp4 decodes to {vid.shape}, not ({frames[sec]}, 720, 1280, 3)")
        with np.load(os.path.join(d19["output_dir"], "results", stem_ + ".npz")) as z:
            drawn[sec] = V2P.generate_video(vcfg, z["poses_pred_batch"][0])
        demo_video[sec] = vid
        sr, wav = wavfile.read(names[1])
        check(sr == 16000 and wav.shape == (demo_batch(clips[sec])["audio"].shape[-1],),
              f"{stem_}.wav: {sr} Hz, {wav.shape}")
    mads = {"own_4.27": drawn_mad(demo_video[4.27], drawn[4.27]),
            "own_10.3": drawn_mad(demo_video[10.3], drawn[10.3]),
            "other_10.3_video_vs_4.27_poses": drawn_mad(demo_video[10.3][:64], drawn[4.27]),
            "other_4.27_video_vs_10.3_poses": drawn_mad(demo_video[4.27], drawn[10.3][:64])}
    check(mads["own_4.27"] < MAD_GATE and mads["own_10.3"] < MAD_GATE,
          f"the demo mp4s differ from their own redrawn poses: {mads} (gate {MAD_GATE})")
    check(min(mads["other_10.3_video_vs_4.27_poses"],
              mads["other_4.27_video_vs_10.3_poses"]) >= MAD_GATE,
          f"a video of the other clip's poses passes the gate: {mads} (gate {MAD_GATE})")
    print(f"[video-demo] main --demo_input of 2 clips with TEST.SAVE_VIDEO True, mp4 + img: "
          f"launches {dict(n)}; videos/, .wav and imgs/ under JAX's names; mp4s decode to "
          f"64 and 154 frames of 720x1280; mean abs diff over drawn pixels vs the npz poses "
          f"redrawn: {mads['own_4.27']:.3f}, {mads['own_10.3']:.3f} (gate < {MAD_GATE}); the "
          f"other clip's: {mads['other_10.3_video_vs_4.27_poses']:.3f}, "
          f"{mads['other_4.27_video_vs_10.3_poses']:.3f} (must fail)", flush=True)
    del demo_video, drawn

    seconds = {"demo": time.perf_counter() - t19}

    # (c) --test_only with videos into TensorBoard and mp4: the metrics phase 13 read
    t0 = time.perf_counter()
    tv, n = cli("--config_file", bp_file, "--test_only", "--checkpoint", ckpt, *eopts,
                "TEST.SAVE_VIDEO", "True", "SYS.VIDEO_FORMAT", "['tensorboard', 'mp4']",
                "SYS.NUM_WORKERS", "2", "SYS.OUTPUT_DIR", os.path.join(vdir, "test"))
    check(n == {"mel": 2, "conv1": 2, "stem": 2, "in_act": 2 * 21},
          f"the test run with videos over 2 eval batches launched {n}")
    p19.update(n)
    tm = tv["metrics"]
    check(tm["L2_dist"] == em["L2_dist"],
          f"test L2_dist with videos {tm['L2_dist']!r} != phase 13's {em['L2_dist']!r}")
    test_metrics_equal = tm == em
    gifs = [e for e in events_of(tv["output_dir"]) if "png" in e]
    check([(e["tag"], e["step"]) for e in gifs] == [("test/video/1", 0), ("test/video/2", 0)],
          f"test video summaries {[(e['tag'], e['step']) for e in gifs]}")
    for e in gifs:
        g = tb_native.gif_decode(e["png"])
        check(g.shape == (64, 288, 512, 3), f"{e['tag']} GIF decodes to {g.shape}")
    check(sorted(os.listdir(os.path.join(tv["output_dir"], "videos"))) == sorted(
        f"epoch0-TEST-step{t}.{x}" for t in (1, 2) for x in ("mp4", "wav")),
        f"test videos {os.listdir(os.path.join(tv['output_dir'], 'videos'))}")
    with open(glob.glob(os.path.join(tv["output_dir"], "*.log"))[0]) as f:
        gif_s = [float(x) for x in re.findall(r"Saved tensorboard videos in ([0-9.]+) s", f.read())]
    seconds["test"] = time.perf_counter() - t0
    print(f"[video-test] --test_only with TEST.SAVE_VIDEO True, tensorboard + mp4: launches "
          f"{dict(n)}; L2_dist {tm['L2_dist']!r} = phase 13's bit for bit (all metrics equal: "
          f"{test_metrics_equal}); test/video/1 and /2 decode to 64 frames of 288x512",
          flush=True)

    # (d) two epochs of SDT-BP and Pose2Pose with TRAIN.SAVE_VIDEO on phase 10's speaker,
    # a result step (and its video) an epoch
    t0 = time.perf_counter()
    train_videos = {}
    for cfg_file, want in ((bp_file, {"mel": 4, "conv1": 0, "stem": 0, "in_act": 0}),
                           (os.path.join(ROOT, "configs", "pose2pose.yaml"),
                            {"mel": 0, "conv1": 0, "stem": 0, "in_act": 0})):
        tr, n = cli("--config_file", cfg_file, *opts, "TRAIN.SAVE_VIDEO", "True",
                    "TRAIN.NUM_EPOCHS", "2", "TRAIN.NUM_RESULT_SAMPLE", "1",
                    "SYS.NUM_WORKERS", "2", "SYS.OUTPUT_DIR", os.path.join(vdir, "train"))
        name = os.path.basename(cfg_file).split(".")[0]
        check(n == want and tr["steps"] == 4, f"{name} training with videos: {n}, {tr}")
        p19.update(n)
        vids = sorted(os.listdir(os.path.join(tr["output_dir"], "videos")))
        check(vids == sorted(f"epoch{e}-TRAIN-step2.{x}" for e in (1, 2) for x in ("mp4", "wav")),
              f"{name} train videos {vids}")
        check(read_mp4(os.path.join(tr["output_dir"], "videos", vids[0])).shape
              == (64, 720, 1280, 3), f"{name} {vids[0]} does not decode to 64 frames")
        figs = [(e["tag"], e["step"]) for e in events_of(tr["output_dir"]) if "png" in e]
        with open(os.path.join(tr["output_dir"], f"{name}-TRAIN-video.log")) as f:
            skipped = f.read().count("epoch plotting: skipped, matplotlib does not import")
        check(figs == [("train/clip_code", 1), ("train/clip_code", 2)] if mpl_version
              else (figs == [] and skipped == 2), f"{name}: figures {figs}, skip lines {skipped}")
        train_videos[name] = {"launches": dict(n), "videos": len(vids) // 2, "figures": figs}
    seconds["train"] = time.perf_counter() - t0
    print(f"[video-train] 2 epochs with TRAIN.SAVE_VIDEO True: {train_videos}", flush=True)

    # (e) timed, not gated: one 64-frame pair video drawn and saved (mp4), sync and
    # async; (c)'s TensorBoard GIFs, from its log; the eval ms per batch of 32, videos
    # off and on
    t_e = time.perf_counter()
    with np.load(os.path.join(tv["output_dir"], "results", "epoch0-TEST-step1.npz")) as z:
        pred, gt = z["poses_pred_batch"][0], z["poses_gt_batch"][0]
    times = {}
    for mode in ("sync", "async"):
        vc = apply_overrides(sdt_bp(), ["SYS.VIDEO_FORMAT", "['mp4']",
                                        "SYS.ASYNC_VIDEO_SAVING", str(mode == "async")])
        vw = VideoWriter(vc)
        t0 = time.perf_counter()
        vw.save_video(vc, "TEST", V2P.generate_video_pair(vc, pred, gt), 1, 0, audio=None,
                      base_path=os.path.join(vdir, f"timed_{mode}"))
        times[f"draw_and_save_{mode}_ms"] = (time.perf_counter() - t0) * 1e3
        vw.close()
        times[f"until_written_{mode}_ms"] = (time.perf_counter() - t0) * 1e3
        check(os.path.exists(os.path.join(vdir, f"timed_{mode}", "videos",
                                          "epoch0-TEST-step1.mp4")), f"{mode} video not written")
    times["tensorboard_gif_ms"] = [x * 1e3 for x in gif_s]
    estate = Voice2PoseTrainState(apply_overrides(sdt_bp(), list(eopts)), None, dev)
    estate.load_pth(ckpt)
    eb32 = [next(iter(trainer.eval_loader(apply_overrides(estate.cfg, ["SYS.NUM_WORKERS",
                                                                       "0"]))))] * 2
    estate.cfg.TEST.SAVE_VIDEO = False
    trainer.evaluate(estate, eb32, 0)  # warm-up
    for on in (False, True):
        estate.cfg.TEST.SAVE_VIDEO = on
        ew = VideoWriter(estate.cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.evaluate(estate, eb32, 0, os.path.join(vdir, f"eval_{on}"), None, ew)
        torch.cuda.synchronize()
        ew.close()
        times[f"eval_ms_per_batch32_videos_{'on' if on else 'off'}"] = \
            (time.perf_counter() - t0) * 1e3 / len(eb32)
    del estate, eb32
    seconds["timed"] = time.perf_counter() - t_e
    for name, v in p19.items():
        report[name]["launches"] += v
    video_line = {"video": {"card": card, "facts": facts, "demo_drawn_mad": mads,
                            "demo_mad_gate": MAD_GATE, "test_l2_equals_phase13": True,
                            "test_metrics_all_equal": test_metrics_equal,
                            "train": train_videos, "times": times, "launches": dict(p19),
                            "seconds": seconds, "phase_seconds": time.perf_counter() - t19}}
    print(f"[video] {facts}; ms: {times}; seconds: {seconds}; phase 19 launched {dict(p19)} "
          f"and took {video_line['video']['phase_seconds']:.1f} s", flush=True)


    # ---- 20. parallel: ranks over torch.distributed, the sequence-parallel demo ----------
    parallel_line = parallel_phase(SimpleNamespace(
        root=root, ckpt=ckpt, s2g_ckpt=c_s2g_resumed["checkpoint"], clip=clips[24.0], em=em,
        card=card, work=work, dev=dev, report=report))

    # ---- 21. loader: the native item loader, what limits the loader -------------------
    loader_line = loader_phase(SimpleNamespace(
        root=long_root, work=work, dev=dev, card=card, loop_rates=loop_rates,
        loader_rate=loader_rate))
    shutil.rmtree(long_root, ignore_errors=True)

    # ---- summary -----------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: report[n][k] for k in keys}
                                  for n in ("mel", "conv1", "stem", "shift_probe", "bn_act",
                                            "in_act")]}))
    print(json.dumps(train_line))
    print(json.dumps(chain_line))
    print(json.dumps({"graphed": graph_line}))
    print(json.dumps(s2g_line))
    print(json.dumps(demo_line))
    print(json.dumps(export_line))
    print(json.dumps(video_line))
    print(json.dumps(parallel_line))
    print(json.dumps(loader_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
