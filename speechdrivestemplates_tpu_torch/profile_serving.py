"""Where the serving forward's device time goes, by kernel, on one CUDA card.

    python -m speechdrivestemplates_tpu_torch.profile_serving [--batch 128] [--iters 5]
        [--config_file configs/NAME.yaml] [--artifact]

Runs the bf16 serving function of the Voice2Pose config file ``--config_file``,
read as ``main.py`` reads it (SDT-BP by default; seeded weights, random
audio, and a random code where the model takes one) under ``torch.profiler``
and prints one JSON line: the forward's mean time from CUDA events, the
device-busy time per forward and the idle share, the host ms a call (the
median time until a call returns, the card idle before it), the kernels a
call, and the kernels ranked by device time per forward.

``--artifact`` measures, the same way and in the same process, the function
exported by ``utils/export.py`` at this batch and loaded back (under
``build/profile_serving/``), and the same program with the runtime checks
``torch.export`` records (``aten._assert_tensor_metadata``) left in; each with
its graph's node count. They go under "artifact" and "artifact_with_asserts".
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import time

import numpy as np
import torch

from .config import load_config
from .models import build_model
from .serving import ServingModule, build_serving_fn
from .utils.device import resolve_device
from .utils.timing import card, cuda_ms


def host_ms(fn, inputs, reps: int) -> float:
    """Median host ms until ``fn(*inputs)`` returns, the card idle before each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*inputs)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def measure(fn, inputs, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    forward_ms = cuda_ms(fn, [inputs], iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*inputs)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # operator rows repeat their kernels' time
        t = e.self_device_time_total
        if t > 0:
            rows.append((e.key, t / 1e3 / iters, e.count / iters))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"forward_ms": forward_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / forward_ms),
            "host_ms": host_ms(fn, inputs, max(iters, 20)),
            "kernels_per_call": sum(r[2] for r in rows),
            "kernels": [{"name": k[:90], "ms": round(ms, 4), "calls": n}
                        for k, ms, n in rows[:25]]}


def graph_nodes(program) -> dict:
    """The program's call nodes, and of them the runtime metadata checks."""
    targets = collections.Counter(str(n.target) for n in program.graph.nodes
                                  if n.op == "call_function")
    return {"call_nodes": sum(targets.values()),
            "assert_tensor_metadata": targets["aten._assert_tensor_metadata.default"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--config_file", default="", metavar="FILE",
                    help="a Voice2Pose config file (default: SDT-BP's tree)")
    ap.add_argument("--artifact", action="store_true",
                    help="also the exported artifact, with and without its runtime checks")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")

    cfg = load_config(args.config_file)
    if cfg.PIPELINE_TYPE != "Voice2Pose":
        ap.error(f"--config_file {args.config_file}: not a Voice2Pose configuration")
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
    out = {"card": card(), "config_file": args.config_file or "configs/voice2pose_sdt_bp.yaml",
           "batch": args.batch, **measure(fn, inputs, args.iters)}
    out["pose_frames_per_s"] = args.batch * cfg.DATASET.NUM_FRAMES / out["forward_ms"] * 1e3

    if args.artifact:
        from .utils.export import export_serving_fn, load_serving_fn

        work = os.path.join("build", "profile_serving")
        os.makedirs(work, exist_ok=True)
        ckpt, path = os.path.join(work, "seeded.pth"), os.path.join(work, "serving.pt2")
        torch.save({"model_state_dict": {"module.netG." + k: v for k, v in sd.items()}}, ckpt)
        export_serving_fn(cfg, ckpt, path, batch_size=args.batch, device=dev)
        art = load_serving_fn(path)
        out["artifact"] = {**graph_nodes(torch.export.load(path)),
                           **measure(art, inputs, args.iters)}
        module = ServingModule(cfg, sd, dev)
        with torch.no_grad():
            program = torch.export.export(module, inputs)
        checked = torch.inference_mode()(program.module())
        out["artifact_with_asserts"] = {**graph_nodes(program),
                                        **measure(checked, inputs, args.iters)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
