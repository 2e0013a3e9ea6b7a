"""Where the serving forward's device time goes, by kernel, on one CUDA card.

    python -m speechdrivestemplates_tpu_torch.profile_serving [--batch 128] [--iters 5]
        [--config_file configs/NAME.yaml]

Runs the bf16 serving function of the Voice2Pose preset ``--config_file``
names, as ``main.py`` picks it (SDT-BP by default; seeded weights, random
audio, and a random code where the model takes one) under ``torch.profiler``
and prints one JSON line: the forward's mean time from CUDA events, the
device-busy time per forward, and the kernels ranked by device time per
forward.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .config import preset_for_config_file, sdt_bp
from .models import build_model
from .serving import build_serving_fn
from .utils.device import resolve_device
from .utils.timing import card, cuda_ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--config_file", default="", metavar="FILE",
                    help="configs/<name>.yaml: the Voice2Pose preset (default SDT-BP)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    from torch.profiler import ProfilerActivity, profile

    cfg = preset_for_config_file(args.config_file) if args.config_file else sdt_bp()
    if cfg.PIPELINE_TYPE != "Voice2Pose":
        ap.error(f"--config_file {args.config_file}: not a Voice2Pose preset")
    sd = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    fn, has_code = build_serving_fn(cfg, sd, dev)
    rng = np.random.RandomState(0)
    audio = torch.from_numpy((rng.randn(args.batch, cfg.DATASET.AUDIO_LENGTH) * 0.1)
                             .astype(np.float32)).to(dev)
    inputs = (audio,)
    if has_code:
        dim = cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION
        inputs += (torch.from_numpy(rng.randn(args.batch, dim).astype(np.float32)).to(dev),)
    forward_ms = cuda_ms(fn, [inputs], args.iters)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            fn(*inputs)
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
        "card": card(), "config_file": args.config_file or "configs/voice2pose_sdt_bp.yaml",
        "batch": args.batch, "forward_ms": forward_ms,
        "pose_frames_per_s": args.batch * cfg.DATASET.NUM_FRAMES / forward_ms * 1e3,
        "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / forward_ms),
        "kernels": [{"name": k[:90], "ms": round(ms, 4), "calls": n}
                    for k, ms, n in rows[:25]]}))


if __name__ == "__main__":
    main()
