"""Timing on the card: CUDA-event means, and the card's name and power limit."""

from __future__ import annotations

import subprocess

import torch


def cuda_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean ms of ``fn(*args)`` over ``iters`` calls by CUDA events, after one
    warm-up call per argument set. Calls rotate over ``arg_sets``: with a few
    copies of inputs larger than the 50 MB L2, each call reads device memory."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi unavailable"
