"""Where the serving forward's device time goes, by kernel, on one CUDA card.

    python -m speechdrivestemplates_tpu_torch.profile_serving [--batch 128] [--iters 5]

Runs the SDT-BP bf16 serving function (seeded weights, random audio and code)
under ``torch.profiler`` and prints one JSON line: the forward's mean time
from CUDA events, the device-busy time per forward, and the kernels ranked by
device time per forward.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .config import sdt_bp
from .models import build_model
from .serving import build_serving_fn
from .utils.device import resolve_device
from .utils.timing import card, cuda_ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    from torch.profiler import ProfilerActivity, profile

    cfg = sdt_bp()
    sd = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    fn, _ = build_serving_fn(cfg, sd, dev)
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(args.batch, cfg.DATASET.AUDIO_LENGTH) * 0.1)
                             .astype(np.float32)).to(dev)
    code = torch.from_numpy(rng.randn(args.batch, 32).astype(np.float32)).to(dev)
    forward_ms = cuda_ms(fn, [(audio, code)], args.iters)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            fn(audio, code)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat their kernels' time
        t = e.self_device_time_total
        if t > 0:
            rows.append((e.key, t / 1e3 / args.iters, e.count // args.iters))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(json.dumps({
        "card": card(), "batch": args.batch, "forward_ms": forward_ms,
        "pose_frames_per_s": args.batch * cfg.DATASET.NUM_FRAMES / forward_ms * 1e3,
        "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / forward_ms),
        "kernels": [{"name": k[:90], "ms": round(ms, 4), "calls": n}
                    for k, ms, n in rows[:25]]}))


if __name__ == "__main__":
    main()
