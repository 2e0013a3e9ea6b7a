#!/usr/bin/env python
"""wav -> poses from an exported serving artifact (``main --export``), without
the port's model code: the counterpart of the JAX package's
``serving/run_artifact.py``.

    python speechdrivestemplates_tpu_torch/run_artifact.py ART in.wav out.npz \
        [--code-seed N] [--device cuda|cpu] [--bench ITERS] [--bench-out PATH]

It imports torch, numpy and, of the port, the kernel ops that a card's
artifact calls (``kernels``, which ``torch.export.load`` needs registered
first), the artifact loader (``utils/export.py``) and the wav reader
(``utils/audio.py``): no model, pipeline, dataset, config or serving module.
The artifact's shapes are static: the wav (read as the serving command line
reads it) is cropped or zero-padded to the exported length, into row 0 of the
exported batch. A code model's code is ``RandomState(code_seed).randn(B, D)``,
whose row 0 is the serving command line's code for the same seed, so the two
write the same poses. ``--device`` must be the one the artifact was exported
for (the card unless ``--device cpu``); a CUDA artifact raises without a card.

``--bench ITERS`` then times the artifact on device-resident inputs cycled
over 4 buffers, as the JAX runner does: two runs of ITERS and 4 x ITERS calls,
timed by CUDA events on the card (the host clock on the CPU), and the slope
between them, which cancels what a run costs once. It prints one JSON line,
``{"metric": "served_frames_per_sec", "value", "unit", "batch",
"per_call_ms", "device"}``, and writes it to ``--bench-out`` if given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if not __package__:  # run by its path: the repository root, not this directory
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

from speechdrivestemplates_tpu_torch.utils.audio import load_wav
from speechdrivestemplates_tpu_torch.utils.export import load_serving_fn

N_BUFFERS = 4


def bench(fn, meta: dict, device: torch.device, iters: int) -> dict:
    B, L, D = meta["batch_size"], meta["audio_length"], meta["code_dim"]
    rng = np.random.RandomState(0)
    audios = [torch.from_numpy(rng.randn(B, L).astype(np.float32) * 0.1).to(device)
              for _ in range(N_BUFFERS)]
    codes = ([torch.from_numpy(rng.randn(B, D).astype(np.float32)).to(device)
              for _ in range(N_BUFFERS)] if D else [None] * N_BUFFERS)

    def run(n):
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for i in range(n):
                fn(audios[i % N_BUFFERS], codes[i % N_BUFFERS])
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / 1e3
        t0 = time.perf_counter()
        for i in range(n):
            fn(audios[i % N_BUFFERS], codes[i % N_BUFFERS])
        return time.perf_counter() - t0

    run(N_BUFFERS + 1)  # warm-up
    n1, n2 = iters, 4 * iters
    per_call = (run(n2) - run(n1)) / (n2 - n1)
    return {"metric": "served_frames_per_sec", "value": B * meta["num_frames"] / per_call,
            "unit": "frames/s", "batch": B, "per_call_ms": per_call * 1e3,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="run_artifact.py",
                                 description="wav -> poses from a main --export artifact")
    ap.add_argument("artifact")
    ap.add_argument("wav")
    ap.add_argument("out", help="output npz (poses in pixel space)")
    ap.add_argument("--code-seed", type=int, default=0,
                    help="seed of the N(0,1) template code (code models only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the artifact was exported for")
    ap.add_argument("--bench", type=int, default=0, metavar="ITERS",
                    help="then time the artifact over ITERS and 4 x ITERS device-resident "
                         "calls and print a frames/s JSON line")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="also write the --bench JSON line to PATH")
    args = ap.parse_args(argv)

    fn = load_serving_fn(args.artifact, args.device)
    meta = fn.meta
    device = torch.device(meta["device"])
    B, L = meta["batch_size"], meta["audio_length"]
    audio = load_wav(args.wav, meta["sample_rate"])
    clipped = len(audio) > L
    buf = np.zeros((B, L), np.float32)
    buf[0, : min(len(audio), L)] = audio[:L]
    code = None
    if meta["code_dim"]:
        code = np.random.RandomState(args.code_seed).randn(B, meta["code_dim"]).astype(
            np.float32)
    poses = fn(buf, code)[0].float().cpu().numpy()  # (T, 2, K)

    np.savez(args.out, poses=poses, fps=15, num_frames=meta["num_frames"],
             speaker=meta["speaker"])
    note = " (input clipped to the exported length)" if clipped else ""
    print(f"{poses.shape[0]} pose frames ({poses.shape[-1]} keypoints) "
          f"-> {args.out}{note}")

    if args.bench:
        rec = bench(fn, meta, device, args.bench)
        print(json.dumps(rec))
        if args.bench_out:
            with open(args.bench_out, "w") as f:
                json.dump(rec, f)


if __name__ == "__main__":
    main()
