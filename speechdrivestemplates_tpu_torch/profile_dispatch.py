"""Host time of the port's calls where the host sets the pace, on one CUDA card:
what a kernel's dispatch costs a B = 1 request, a short demo clip and a
streaming session.

    python -m speechdrivestemplates_tpu_torch.profile_dispatch [--reps 50] [--work DIR]

Prints one JSON line with the card's name and power limit and, in ms on the
host clock:

  mel_b1_ms, conv1_b1_ms, stem_b1_ms  a call of each kernel's wrapper at a B = 1
      request's shapes ((1, 68267) audio; its (1, 80, 427) mel; conv1's bf16
      (1, 82, 427, 64) output), ``reps`` calls enqueued back to back and one
      synchronize: the host's cost a call where it exceeds the kernel's
  serve_b1_ms       a B = 1 request of ``build_serving_fn`` (SDT-BP bf16, seeded
      weights), synchronized; the median of ``reps`` (one signature: from the
      third call on, a CUDA-graph replay)
  dense_demo_4_27s_ms  ``voice2pose.demo_step`` of a 4.27 s clip (64 frames,
      the dense route), synchronized; the median of ``reps``
  stream_24s_ms     a 24 s clip through ``StreamingPoseSession`` over the B = 1
      request's function in 0.5 s chunks (11 windows of 68,266 samples), as
      ``chip_smoke.py`` phase 17 streams it; the median of ``reps // 5``

It calls only functions the port has had since its demo slice, so that one
chip call can run it in two checkouts, in turns, and compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from .config import apply_overrides, sdt_bp
from .datasets.gesture_dataset import GestureDataset, collate
from .models import build_model
from .ops import conv1 as C1
from .ops import mel as M
from .ops import stem as S
from .pipelines import voice2pose as V2P
from .serving import build_serving_fn
from .utils.device import resolve_device
from .utils.streaming import StreamingPoseSession
from .utils.timing import card


def enqueued_ms(fn, reps: int) -> float:
    """Host ms a call over ``reps`` calls issued back to back, synchronized
    once at the end, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def median_ms(fn, reps: int) -> float:
    """Median host ms of ``reps`` synchronized calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.profile_dispatch")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--work", default=os.path.join("build", "profile_dispatch"),
                    help="directory of the demo clip")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    rng = np.random.RandomState(0)
    os.makedirs(args.work, exist_ok=True)

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    bf = torch.bfloat16
    cfg = sdt_bp()
    sd = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    fn, _ = build_serving_fn(cfg, sd, device=dev)
    audio, code = randn(1, 68267, scale=0.1), randn(1, 32)
    w1, w2, w3 = (randn(64, 1, 3, 3, scale=0.2), randn(64, 64, 4, 4, scale=0.05),
                  randn(128, 64, 3, 3, scale=0.05))
    with torch.inference_mode():
        mel = M.mel_spectrogram(audio)
        y1 = C1.conv1_in_kernel(mel, w1, 0.2, bf)
        out = {"card": card(), "torch": torch.__version__, "reps": args.reps,
               "mel_b1_ms": enqueued_ms(lambda: M.mel_spectrogram_kernel(audio), args.reps),
               "conv1_b1_ms": enqueued_ms(lambda: C1.conv1_in_kernel(mel, w1, 0.2, bf),
                                          args.reps),
               "stem_b1_ms": enqueued_ms(lambda: S.stem_tail_kernel(y1, w2, w3, 0.2, bf),
                                         args.reps)}
    out["serve_b1_ms"] = median_ms(lambda: fn(audio, code), args.reps)

    from scipy.io import wavfile

    wav = os.path.join(args.work, "clip_4.27.wav")
    t = np.arange(int(4.27 * 16000)) / 16000
    wavfile.write(wav, 16000, (0.1 * np.sin(2 * np.pi * 140 * t) * 32767).astype(np.int16))
    batch = collate([GestureDataset("unused", "oliver", cfg, split="demo", demo_input=wav)[0]])
    state = V2P.Voice2PoseTrainState(
        apply_overrides(sdt_bp(), ["TEST.SAVE_VIDEO", "False", "DEMO.CODE_INDEX", "0"]), None,
        dev)
    out["dense_demo_4_27s_ms"] = median_ms(lambda: V2P.demo_step(state, batch), args.reps)
    del state

    clip = (rng.randn(24 * 16000) * 0.1).astype(np.float32)

    def stream():
        sess = StreamingPoseSession(lambda a: fn(a, code).float().cpu().numpy())
        for i in range(0, len(clip), 8000):
            sess.feed(clip[i: i + 8000])
        return sess.flush()

    out["stream_24s_ms"] = median_ms(stream, max(args.reps // 5, 3))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
