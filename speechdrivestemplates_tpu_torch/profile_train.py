"""Where a Voice2Pose train step's device time goes, by kernel, on one CUDA card.

    python -m speechdrivestemplates_tpu_torch.profile_train [--batch 32] [--iters 5]
        [--device-cache] [--steps-per-dispatch K] [--config_file configs/NAME.yaml]

Builds the bf16 train state of the config file ``--config_file``, read as
``main.py`` reads it (SDT-BP by default; ``configs/voice2pose_s2g.yaml`` for
s2g-GAN; weights seeded with 0, a train set of 64 clips) and runs
``pipelines.voice2pose.train_step`` on a device-resident batch (random audio
and normalized poses, the speaker's statistics), first timed by CUDA events,
then under ``torch.profiler``. With ``--device-cache`` each step's
batch is gathered from a device-resident train set of 64 random clips, as
the trainer's DATASET.DEVICE_CACHE gathers it (``pipelines/graphed.py``);
``--steps-per-dispatch K`` > 1 runs K such steps in one CUDA graph (the state
built capturable; the first chunk eager, the second captured, then replays),
and ``--iters`` counts chunks. Prints one JSON line: the step's mean
time; from the profiled steps alone (the card's activity only is traced),
their mean time by CUDA events around the same window, the device-busy time
per step and the idle share of that window, the kernels per step; the device
time per step by kind (the mel kernel, cuDNN convolution forward / data
gradient / weight gradient, the Adam updates, the rest), the kernels ranked
by device time, the forward + backward time of the audio encoder's first three
layers at the step's shapes (an IN encoder's plain stem, a BN encoder's own
layers), and the launch counts of the port's kernels over the
warm-up and timed steps (host launches, captured, replayed, executed).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import kernels
from .config import load_config
from .datasets.speakers_stat import get_speaker_stat
from .ops.stem import stem_plain
from .pipelines.graphed import ChunkRunner
from .pipelines.voice2pose import Voice2PoseTrainState, train_step
from .utils.device import resolve_device
from .utils.timing import card, cuda_ms

# kernel-name fragments -> kind, first match wins
KINDS = (("mel_kernel", "mel kernel (B1)"), ("dgrad", "conv backward, data"),
         ("wgrad", "conv backward, weights"), ("fprop", "conv forward"),
         ("multi_tensor_apply", "Adam updates"))


def kind_of(name: str) -> str:
    return next((k for frag, k in KINDS if frag in name), "other: elementwise, reductions, "
                                                         "copies, layout conversions")


def train_batch(cfg, batch: int, num_train: int, device, seed: int = 0) -> dict:
    """A random batch in the loader's form, on ``device``: audio of the
    snapped clip length, N(0, 1) normalized poses, the speaker's statistics
    (the parted or the global table, as DATASET.HIERARCHICAL_POSE says; on
    global poses the global table again as ``speaker_stat_global``)."""
    rng = np.random.RandomState(seed)
    parted = cfg.DATASET.HIERARCHICAL_POSE
    length = int(cfg.DATASET.NUM_FRAMES * cfg.DATASET.AUDIO_SR / cfg.DATASET.FPS)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def stat(parted):
        return {k: dev(np.repeat(np.asarray(v)[None], batch, 0)) for k, v in
                get_speaker_stat(cfg.DATASET.SPEAKER, cfg.DATASET.NUM_LANDMARKS, parted).items()}

    out = {"audio": dev((rng.randn(batch, length) * 0.1).astype(np.float32)),
           "poses": dev(rng.randn(batch, cfg.DATASET.NUM_FRAMES, 2,
                                  cfg.DATASET.NUM_LANDMARKS).astype(np.float32)),
           "clip_index": dev(np.arange(batch) % num_train),
           "speaker_stat": stat(parted)}
    if not parted:
        out["speaker_stat_global"] = stat(False)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.profile_train")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device-cache", action="store_true",
                    help="gather each batch from a device-resident train set")
    ap.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                    help="K > 1: K steps in one CUDA graph (needs --device-cache)")
    ap.add_argument("--config_file", default="", metavar="FILE",
                    help="a Voice2Pose config file (default: SDT-BP's tree)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    K = args.steps_per_dispatch
    if K > 1 and not args.device_cache:
        ap.error("--steps-per-dispatch > 1 needs --device-cache")
    from torch.profiler import ProfilerActivity, profile

    cfg = load_config(args.config_file)
    if cfg.PIPELINE_TYPE != "Voice2Pose":
        ap.error(f"--config_file {args.config_file}: not a Voice2Pose configuration")
    num_train = 64
    state = Voice2PoseTrainState(cfg, num_train, dev, capturable=K > 1)
    batch = train_batch(cfg, args.batch, num_train, dev)
    kernels.reset_launch_counts()
    if args.device_cache:
        cache = train_batch(cfg, num_train, num_train, dev, seed=1)
        runner = ChunkRunner(state, train_step, cache, graphed=K > 1)
        rng = np.random.RandomState(0)
        chunk = torch.from_numpy(np.stack([rng.permutation(num_train)[:args.batch]
                                           for _ in range(K)])).to(dev)

        def unit():
            runner.run(chunk)

        unit()  # the first chunk eager; with K > 1 the next one captures
    else:
        def unit():
            train_step(state, batch)
    unit()
    step_ms = cuda_ms(unit, [()], args.iters) / K  # a unit is K steps
    launches = {"host": dict(kernels.LAUNCHES), "captured": dict(kernels.CAPTURED),
                "replayed": dict(kernels.REPLAYED), "executed": dict(kernels.executions())}

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # the card's activity only: recording every host-side op as well would
    # lengthen the host-bound step it measures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            unit()
        end.record()
        torch.cuda.synchronize()
    steps = args.iters * K
    window_ms = start.elapsed_time(end) / steps
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Optimizer."):
            continue  # operator rows and the optimizer's annotated range repeat kernels' time
        t = e.self_device_time_total
        if t > 0:
            rows.append((e.key, t / 1e3 / steps, e.count / steps))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy > window_ms:  # one stream: kernels cannot overlap within the window
        raise RuntimeError(f"device busy {busy} ms a step exceeds the profiled step "
                           f"{window_ms} ms: the profile and the window disagree")
    kinds: dict = {}
    for name, ms, _ in rows:
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms

    # the encoder's first three layers, forward and backward, at the step's shapes
    encoder = state.generator.audio_encoder
    layers = encoder.layers()[:3]
    mel = torch.randn(args.batch, 80, batch["audio"].shape[-1] // 160 + 1, device=dev)

    def stem_fwd_bwd():
        if encoder.norm == "BN":
            out = mel[:, None]
            for m in layers:
                out = m(out)
        else:
            out = stem_plain(mel, *(m.conv.weight for m in layers), slope=layers[0].slope,
                             dtype=state.generator.dtype)
        out.float().sum().backward()

    stem_ms = cuda_ms(stem_fwd_bwd, [()], args.iters)
    state.opt_g.zero_grad(set_to_none=True)
    print(json.dumps({
        "card": card(), "config_file": args.config_file or "configs/voice2pose_sdt_bp.yaml",
        "batch": args.batch, "precision": cfg.TRAIN.PRECISION,
        "device_cache": args.device_cache, "steps_per_dispatch": K,
        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "profiled_step_ms": window_ms, "device_busy_ms": busy,
        "idle_share": 1 - busy / window_ms,
        "kernels_per_step": sum(r[2] for r in rows),
        "by_kind_ms": {k: round(v, 4) for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])},
        "stem_fwd_bwd_ms": stem_ms, "launches": launches,
        "kernels": [{"name": k[:90], "ms": round(ms, 4), "calls": round(n, 2)}
                    for k, ms, n in rows[:30]]}))


if __name__ == "__main__":
    main()
