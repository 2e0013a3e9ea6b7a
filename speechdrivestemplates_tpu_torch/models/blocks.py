"""Conv -> norm -> (leaky) ReLU, 1D and 2D (JAX ``models/blocks.py``
``ConvNormRelu`` with ``norm='IN'`` or ``'BN'``).

Layouts are PyTorch's: 2D tensors (B, C, H, W), 1D tensors (B, C, T).
Norm semantics follow the reference's runtime behaviour:
  * IN on 2D: per-(sample, channel) normalization over (H, W), biased
    variance, eps 1e-5, no affine.
  * IN on 1D: the reference permutes to (B, T, C) before InstanceNorm1d, so
    it normalizes over the CHANNEL axis at each time position.
  * BN: torch BatchNorm (momentum 0.1, eps 1e-5, affine, running statistics
    whose variance EMA takes the unbiased batch variance), the JAX package's
    ``TorchBatchNorm``.
Statistics are taken in at least fp32 (float64 stays float64) whatever the
compute dtype. Convolutions run in the compute dtype with the fp32 parameters
cast to it, as flax ``nn.Conv(dtype=)`` does. Init: Kaiming normal, fan_in,
gain sqrt(2), from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-5
LEAKY_SLOPE = 0.2
BN_MOMENTUM = 0.1  # torch convention: weight of the new batch statistic


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def instance_norm_2d(x: torch.Tensor) -> torch.Tensor:
    """Affine-free normalization over (H, W) of a (B, C, H, W) tensor."""
    xf = x.to(_stats_dtype(x))
    var, mean = torch.var_mean(xf, dim=(-2, -1), correction=0, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + NORM_EPS)


def channel_norm_1d(x: torch.Tensor) -> torch.Tensor:
    """The reference's IN-1d: normalize a (B, C, T) tensor over C at each t."""
    xf = x.to(_stats_dtype(x))
    var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + NORM_EPS)


def conv_norm_relu_2d(x: torch.Tensor, weight: torch.Tensor, stride, padding,
                      slope: float, dtype: torch.dtype) -> torch.Tensor:
    """One IN-normalized 2D ConvNormRelu in the compute dtype."""
    y = F.conv2d(x.to(dtype), weight.to(dtype), stride=stride, padding=padding)
    return F.leaky_relu(instance_norm_2d(y), slope).to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over a (B, C, T) tensor, reducing over (B, T).

    Train mode normalizes with the biased batch variance and moves the running
    statistics by ``BN_MOMENTUM``, the variance by its unbiased n/(n-1) form;
    eval mode normalizes with the running statistics. Parameter and buffer
    names are torch's (``weight``, ``bias``, ``running_mean``, ``running_var``,
    ``num_batches_tracked``), so reference checkpoints load with
    ``strict=True``. Returns the normalized tensor in the statistics dtype
    (fp32 for fp32 and bf16 inputs); the caller casts."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stats_dtype(x))
        if self.training:
            var, mean = torch.var_mean(xf, dim=(0, 2), correction=0)
            n = xf.shape[0] * xf.shape[2]
            with torch.no_grad():
                m = 1.0 - BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + BN_MOMENTUM * mean)
                self.running_var.copy_(m * self.running_var
                                       + BN_MOMENTUM * (var * (n / max(n - 1, 1))))
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean[:, None]) * torch.rsqrt(var[:, None] + NORM_EPS)
        return y * self.weight[:, None] + self.bias[:, None]


def _kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


class ConvNormRelu(nn.Module):
    """k3 s1 p1 by default, k4 s2 p1 when ``downsample``; no conv bias.

    ``conv_type`` is '1d' or '2d'; ``kernel_size``/``stride``/``padding``
    override the defaults (ints or per-axis tuples, torch semantics). ``norm``
    is 'IN' (1D or 2D) or 'BN' (1D, submodule ``norm``).
    """

    def __init__(self, conv_type: str, in_channels: int, out_channels: int,
                 downsample: bool = False, kernel_size=None, stride=None,
                 padding=None, norm: str = "IN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if norm not in ("IN", "BN") or (norm == "BN" and conv_type != "1d"):
            raise NotImplementedError(f"norm {norm!r} on a {conv_type} conv: the port "
                                      "has IN (1d, 2d) and BN (1d)")
        if kernel_size is None:
            kernel_size, stride, padding = (4, 2, 1) if downsample else (3, 1, 1)
        conv = {"1d": nn.Conv1d, "2d": nn.Conv2d}[conv_type]
        self.conv = conv(in_channels, out_channels, kernel_size, stride, padding,
                         bias=False)
        _kaiming_normal_(self.conv.weight, generator or torch.Generator())
        self.norm = BatchNorm(out_channels) if norm == "BN" else None
        self.conv_type = conv_type
        self.slope = LEAKY_SLOPE if leaky else 0.0
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        if self.conv_type == "2d":
            return conv_norm_relu_2d(x, c.weight, c.stride, c.padding, self.slope,
                                     self.dtype)
        y = F.conv1d(x.to(self.dtype), c.weight.to(self.dtype), stride=c.stride,
                     padding=c.padding)
        y = channel_norm_1d(y) if self.norm is None else self.norm(y)
        return F.leaky_relu(y, self.slope).to(self.dtype)
