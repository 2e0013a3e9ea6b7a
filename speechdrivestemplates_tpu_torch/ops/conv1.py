"""The audio encoder's first layer, conv1 + InstanceNorm + lrelu, fused.

    conv1 1->64 k3 s1 p1 (9 fp32 FMAs per output), IN (fp32, biased variance,
    eps 1e-5), lrelu, cast to the compute dtype

The output is (B, 82, W1, 64) channels last, rows 0 and 81 exactly zero: the
activation pre-padded in h for the next layer, conv2 (k4 s2), which runs with
padding (0, 1). The counterpart of the JAX package's ``probes/conv1_pallas.py``
(``fused_conv1_in``), which takes an HWIO weight; this one takes PyTorch's
OIHW (64, 1, 3, 3).

``fused_conv1_in`` is the entry: the CUDA kernel (``csrc/conv1.cu``, the op
``torch.ops.sdt.conv1_in``) on a CUDA tensor, ``conv1_in_plain`` on a CPU
tensor. The kernel takes its statistics from the Gram matrix of the nine
shifted mel views in fp64 and folds the norm into the taps;
``conv1_stats_gram`` and ``conv1_in_folded`` restate that arithmetic in torch
for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..models.blocks import NORM_EPS

H1 = 80           # mel bins = conv1's output height
ROWS = H1 + 2     # output rows: 0 and 81 are zero
C1 = 64           # conv1 channels


def conv1_in_plain(mel: torch.Tensor, w1: torch.Tensor, slope: float = 0.2,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mel (B, 80, W1) -> (B, 82, W1, 64) in ``dtype``; taps and statistics in
    fp32 whatever ``dtype`` is, cast at the end."""
    B, _, W1 = mel.shape
    xp = F.pad(mel.float(), (1, 1, 1, 1))[..., None]  # zero mel around the plane
    taps = w1.float().reshape(C1, 9)
    acc = torch.zeros((B, H1, W1, C1), dtype=torch.float32, device=mel.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy:dy + H1, dx:dx + W1] * taps[:, 3 * dy + dx]
    var, mean = torch.var_mean(acc, dim=(1, 2), correction=0, keepdim=True)
    y = F.leaky_relu((acc - mean) * torch.rsqrt(var + NORM_EPS), slope)
    return F.pad(y, (0, 0, 0, 0, 1, 1)).to(dtype)


def conv1_stats_gram(mel: torch.Tensor, w1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) mean and 1/sqrt(var + eps) of conv1's output from
    the Gram matrix of the nine shifted mel views, as ``csrc/conv1.cu``'s stats
    kernel computes them; no conv is formed.

    With X_t the zero-padded mel shifted by tap t over the 80 x W1 grid,
    y_c = sum_t w[c, t] X_t, so sum(y_c) = w_c . S and sum(y_c^2) = w_c' G w_c
    with S_t = sum(X_t) and G_tu = sum(X_t X_u), both in fp64 (a product of two
    fp32 values is exact there). Returns two (B, 64) fp32 tensors. Tests only:
    the main path runs the kernel."""
    B, _, W1 = mel.shape
    xp = F.pad(mel.double(), (1, 1, 1, 1))
    views = torch.stack([xp[:, dy:dy + H1, dx:dx + W1].reshape(B, -1)
                         for dy in range(3) for dx in range(3)], 1)  # (B, 9, P)
    s = views.sum(-1)                                                # (B, 9)
    g = views @ views.transpose(1, 2)                                # (B, 9, 9)
    w = w1.double().reshape(C1, 9)
    n = float(H1 * W1)
    mean = s @ w.T / n                                               # (B, 64)
    ey2 = torch.einsum("ct,btu,cu->bc", w, g, w) / n
    var = (ey2 - mean * mean).clamp_min(0.0)
    return mean.float(), torch.rsqrt(var + NORM_EPS).float()


def conv1_in_folded(mel: torch.Tensor, w1: torch.Tensor, slope: float = 0.2,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's apply arithmetic in fp32: the norm folded into the taps,
    a[c, t] = w[c, t] * rstd_c and bias -mean_c * rstd_c, so each output is
    nine fp32 multiply-adds from the bias, then lrelu. Statistics from
    ``conv1_stats_gram``. Tests only."""
    B, _, W1 = mel.shape
    mean, rstd = conv1_stats_gram(mel, w1)
    taps = w1.float().reshape(C1, 9)[None] * rstd[..., None]         # (B, 64, 9)
    xp = F.pad(mel.float(), (1, 1, 1, 1))[..., None]
    acc = (-mean * rstd)[:, None, None, :].expand(B, H1, W1, C1)
    for dy in range(3):
        for dx in range(3):
            acc = torch.addcmul(acc, xp[:, dy:dy + H1, dx:dx + W1],
                                taps[:, None, None, :, 3 * dy + dx])
    return F.pad(F.leaky_relu(acc, slope), (0, 0, 0, 0, 1, 1)).to(dtype)


def conv1_in_kernel(mel: torch.Tensor, w1: torch.Tensor, slope: float = 0.2,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused CUDA kernel; same contract as the plain version. Forward-only:
    raises for an input that requires grad under grad mode."""
    kernels.refuse_grad("the conv1 kernel", mel, w1)
    dev = mel.device
    if dev.type not in kernels.DEVICE_TYPES:
        raise ValueError("conv1 kernel takes CUDA tensors")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv1 kernel writes float32 or bfloat16, not {dtype}")
    if mel.ndim != 3 or mel.shape[1] != H1 or mel.shape[2] < 1:
        raise ValueError(f"expected mel (B, {H1}, W1), got {tuple(mel.shape)}")
    if tuple(w1.shape) != (C1, 1, 3, 3) or w1.device != dev:
        raise ValueError(f"conv1 weight {tuple(w1.shape)} on {w1.device}: "
                         f"expected {(C1, 1, 3, 3)} on {dev}")
    return torch.ops.sdt.conv1_in(mel.float(), w1.float(), float(slope), dtype)


def fused_conv1_in(mel: torch.Tensor, w1: torch.Tensor, slope: float = 0.2,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """lrelu(IN(conv1(mel))), h-pre-padded: the kernel on CUDA, the plain
    version on the CPU."""
    if mel.device.type == "cpu":
        return conv1_in_plain(mel, w1, slope, dtype)
    return conv1_in_kernel(mel, w1, slope, dtype)
