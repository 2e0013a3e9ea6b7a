"""Kernel probes on one CUDA card: the fused conv1 + IN1 kernel and the
tap-shift probe, each beside cuDNN.

    python -m speechdrivestemplates_tpu_torch.profile_kernels [--conv1-probe] [--shift-probe]
        [--probe-c 128] [--batch 128] [--width 427]

With neither probe named, both run.

--conv1-probe: the audio encoder's first layer, bf16, on a (batch, 80, width) mel:
  cudnn conv1+IN1      F.conv2d + F.instance_norm + F.leaky_relu
  kernel conv1+IN1     fused_conv1_in (csrc/conv1.cu), h-padded output
  cudnn seg1+layer1    the cuDNN segment, then conv2 k4 s2 p1 + IN + lrelu
  kernel seg1+layer1   the kernel, then conv2 with padding (0, 1) + IN + lrelu
and the mean relative difference of the two compositions.

--shift-probe: `batch` planes of (20 x 224, C) bf16 through nine (C, C) taps,
4032 output rows each (C from --probe-c, 64 or 128):
  kernel aligned       shift_taps(mode="aligned"): the same view nine times
  kernel subtile       shift_taps(mode="subtile"): nine views, shifted one row each
  cudnn conv1d         F.conv1d over the flattened axis: the subtile function in one call
with each case's share of the 989 TFLOP/s bf16 dense peak, and the relative
difference of the subtile kernel to cuDNN.

Times are CUDA-event means of 20 calls rotating over three input copies. The
last line is one JSON object: the card's name and power limit, every case's
time, and how often each kernel was launched during the run.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .ops.conv1 import fused_conv1_in
from .ops.shift_probe import shift_taps
from .utils.device import resolve_device
from .utils.timing import card, cuda_ms

BF16_PEAK_TFLOPS = 989.0          # H100 SXM, dense (NVIDIA data sheet)
PLANE_H, PLANE_W = 20, 224         # the JAX probe's plane: M = 4480, M_out = 4032
ITERS = 20


def _randn(rng, shape, scale, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _layer(x, w, stride, padding, slope=0.2):
    x = F.conv2d(x, w, stride=stride, padding=padding)
    return F.leaky_relu(F.instance_norm(x), slope)


def conv1_probe(dev, batch: int, width: int) -> dict:
    rng = np.random.RandomState(0)
    bf = torch.bfloat16
    mels = [_randn(rng, (batch, 80, width), 0.1, dev) for _ in range(3)]
    w1 = _randn(rng, (64, 1, 3, 3), 0.2, dev)
    w2 = _randn(rng, (64, 64, 4, 4), 0.05, dev).to(bf)
    w1b = w1.to(bf)

    def cudnn_seg(mel):
        return _layer(mel[:, None].to(bf), w1b, 1, 1)

    def kernel_seg(mel):
        return fused_conv1_in(mel, w1, 0.2, bf)

    cases = {
        "cudnn conv1+IN1": cudnn_seg,
        "kernel conv1+IN1": kernel_seg,
        "cudnn seg1+layer1": lambda m: _layer(cudnn_seg(m), w2, 2, 1),
        "kernel seg1+layer1": lambda m: _layer(kernel_seg(m).permute(0, 3, 1, 2), w2, 2,
                                               (0, 1)),
    }
    ms = {name: cuda_ms(fn, [(m,) for m in mels], ITERS) for name, fn in cases.items()}
    a = cases["cudnn seg1+layer1"](mels[0]).float()
    b = cases["kernel seg1+layer1"](mels[0]).float()
    rel = ((a - b).abs().mean() / (a.abs().mean() + 1e-8)).item()
    print(f"== conv1+IN1 segment, batch {batch}, width {width}, bf16 ==")
    for name, t in ms.items():
        print(f"  {name:<22} {t:9.4f} ms")
    print(f"  mean rel diff of the two seg1+layer1 compositions: {rel:.3e}", flush=True)
    return {"batch": batch, "width": width, "ms": ms, "rel_diff_layer1": rel}


def shift_probe(dev, planes: int, c: int) -> dict:
    rng = np.random.RandomState(0)
    m = PLANE_H * PLANE_W
    m_out = m - 2 * PLANE_W
    xs = [_randn(rng, (planes, m, c), 0.1, dev).to(torch.bfloat16) for _ in range(3)]
    w = _randn(rng, (9, c, c), 0.05, dev).to(torch.bfloat16)
    w_conv = w.permute(2, 1, 0).contiguous()  # (C_out, C_in, 9)

    def cudnn_conv1d(x):
        return F.conv1d(x[:, :m_out + 8].transpose(1, 2), w_conv)

    cases = {
        "kernel aligned": lambda x: shift_taps(x, w, m_out, "aligned"),
        "kernel subtile": lambda x: shift_taps(x, w, m_out, "subtile"),
        "cudnn conv1d": cudnn_conv1d,
    }
    gflop = 2.0 * planes * 9 * m_out * c * c / 1e9
    ms = {name: cuda_ms(fn, [(x,) for x in xs], ITERS) for name, fn in cases.items()}
    share = {name: gflop / t / BF16_PEAK_TFLOPS for name, t in ms.items()}
    ref = cudnn_conv1d(xs[0]).transpose(1, 2).float()
    got = cases["kernel subtile"](xs[0]).float()
    rel = ((got - ref).abs().mean() / (ref.abs().mean() + 1e-8)).item()
    print(f"== tap-shift probe: {planes} planes of ({PLANE_H}x{PLANE_W}, {c}) bf16, "
          f"9 taps, {gflop:.1f} GFLOP ==")
    for name, t in ms.items():
        print(f"  {name:<22} {t:9.4f} ms   {share[name] * 100:5.1f}% of bf16 peak")
    print(f"  mean rel diff, subtile kernel vs cuDNN conv1d: {rel:.3e}", flush=True)
    return {"planes": planes, "C": c, "M": m, "M_out": m_out, "gflop": gflop, "ms": ms,
            "peak_share": share, "rel_diff_cudnn": rel}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.profile_kernels")
    ap.add_argument("--conv1-probe", action="store_true",
                    help="fused conv1+IN1 kernel vs the cuDNN segment")
    ap.add_argument("--shift-probe", action="store_true",
                    help="tap-shift kernel, aligned and subtile, vs cuDNN conv1d")
    ap.add_argument("--probe-c", type=int, default=128, choices=(64, 128),
                    help="channels of the shift probe")
    ap.add_argument("--batch", type=int, default=128,
                    help="mel batch of the conv1 probe, planes of the shift probe")
    ap.add_argument("--width", type=int, default=427, help="mel width of the conv1 probe")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    both = not (args.conv1_probe or args.shift_probe)
    kernels.reset_launch_counts()
    result = {"card": card(), "device": torch.cuda.get_device_name(dev)}
    if args.conv1_probe or both:
        result["conv1_probe"] = conv1_probe(dev, args.batch, args.width)
    if args.shift_probe or both:
        result["shift_probe"] = shift_probe(dev, args.batch, args.probe_c)
    result["launches"] = dict(kernels.LAUNCHES)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
