"""Where the SDT-BP train step's device time goes, by kernel, on one CUDA card.

    python -m speechdrivestemplates_tpu_torch.profile_train [--batch 32] [--iters 5]

Builds the bf16 train state (weights seeded with 0, a bank of 64 codes) and
runs ``pipelines.voice2pose.train_step`` on a device-resident batch (random
audio and normalized poses, the speaker's statistics), first timed by CUDA
events, then under ``torch.profiler``. Prints one JSON line: the step's mean
time; from the profiled steps alone (the card's activity only is traced),
their mean time by CUDA events around the same window, the device-busy time
per step and the idle share of that window; the device time per
step by kind (the mel kernel, cuDNN convolution forward / data gradient /
weight gradient, the Adam updates, the rest), the kernels ranked by device
time, the forward + backward time of the stem's three plain layers at the
step's shapes, and the launch counts of the port's kernels over the
warm-up and timed steps.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import kernels
from .config import sdt_bp
from .datasets.speakers_stat import get_speaker_stat
from .ops.stem import stem_plain
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
    snapped clip length, N(0, 1) normalized poses, the speaker's statistics."""
    rng = np.random.RandomState(seed)
    stat = get_speaker_stat(cfg.DATASET.SPEAKER, cfg.DATASET.NUM_LANDMARKS, True)
    length = int(cfg.DATASET.NUM_FRAMES * cfg.DATASET.AUDIO_SR / cfg.DATASET.FPS)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"audio": dev((rng.randn(batch, length) * 0.1).astype(np.float32)),
            "poses": dev(rng.randn(batch, cfg.DATASET.NUM_FRAMES, 2,
                                   cfg.DATASET.NUM_LANDMARKS).astype(np.float32)),
            "clip_index": dev(np.arange(batch) % num_train),
            "speaker_stat": {k: dev(np.repeat(np.asarray(v)[None], batch, 0))
                             for k, v in stat.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.profile_train")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    from torch.profiler import ProfilerActivity, profile

    cfg = sdt_bp()
    num_train = 64
    state = Voice2PoseTrainState(cfg, num_train, dev)
    batch = train_batch(cfg, args.batch, num_train, dev)
    kernels.reset_launch_counts()
    step_ms = cuda_ms(lambda: train_step(state, batch), [()], args.iters)
    launches = dict(kernels.LAUNCHES)

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # the card's activity only: recording every host-side op as well would
    # lengthen the host-bound step it measures
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / args.iters
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Optimizer."):
            continue  # operator rows and the optimizer's annotated range repeat kernels' time
        t = e.self_device_time_total
        if t > 0:
            rows.append((e.key, t / 1e3 / args.iters, e.count // args.iters))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy > window_ms:  # one stream: kernels cannot overlap within the window
        raise RuntimeError(f"device busy {busy} ms a step exceeds the profiled step "
                           f"{window_ms} ms: the profile and the window disagree")
    kinds: dict = {}
    for name, ms, _ in rows:
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms

    # the stem's three plain layers, forward and backward, at the step's shapes
    layers = state.generator.audio_encoder.layers()[:3]
    weights = [m.conv.weight for m in layers]
    mel = torch.randn(args.batch, 80, batch["audio"].shape[-1] // 160 + 1, device=dev)

    def stem_fwd_bwd():
        out = stem_plain(mel, *weights, slope=layers[0].slope, dtype=state.generator.dtype)
        out.float().sum().backward()

    stem_ms = cuda_ms(stem_fwd_bwd, [()], args.iters)
    state.opt_g.zero_grad(set_to_none=True)
    print(json.dumps({
        "card": card(), "batch": args.batch, "precision": cfg.TRAIN.PRECISION,
        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "profiled_step_ms": window_ms, "device_busy_ms": busy,
        "idle_share": 1 - busy / window_ms,
        "by_kind_ms": {k: round(v, 4) for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])},
        "stem_fwd_bwd_ms": stem_ms, "launches": launches,
        "kernels": [{"name": k[:90], "ms": round(ms, 4), "calls": n}
                    for k, ms, n in rows[:30]]}))


if __name__ == "__main__":
    main()
