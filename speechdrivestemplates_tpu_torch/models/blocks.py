"""Conv -> InstanceNorm -> (leaky) ReLU, 1D and 2D (JAX ``models/blocks.py``
``ConvNormRelu`` with ``norm='IN'``; BatchNorm comes with a later slice).

Layouts are PyTorch's: 2D tensors (B, C, H, W), 1D tensors (B, C, T).
Norm semantics follow the reference's runtime behaviour:
  * IN on 2D: per-(sample, channel) normalization over (H, W), biased
    variance, eps 1e-5, no affine.
  * IN on 1D: the reference permutes to (B, T, C) before InstanceNorm1d, so
    it normalizes over the CHANNEL axis at each time position.
Statistics are fp32 whatever the compute dtype. Convolutions run in the
compute dtype with the fp32 parameters cast to it, as flax ``nn.Conv(dtype=)``
does. Init: Kaiming normal, fan_in, gain sqrt(2), from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_EPS = 1e-5
LEAKY_SLOPE = 0.2


def instance_norm_2d(x: torch.Tensor) -> torch.Tensor:
    """Affine-free normalization over (H, W) of a (B, C, H, W) tensor, in fp32."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(-2, -1), correction=0, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + NORM_EPS)


def channel_norm_1d(x: torch.Tensor) -> torch.Tensor:
    """The reference's IN-1d: normalize a (B, C, T) tensor over C at each t, in fp32."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + NORM_EPS)


def conv_norm_relu_2d(x: torch.Tensor, weight: torch.Tensor, stride, padding,
                      slope: float, dtype: torch.dtype) -> torch.Tensor:
    """One IN-normalized 2D ConvNormRelu in the compute dtype."""
    y = F.conv2d(x.to(dtype), weight.to(dtype), stride=stride, padding=padding)
    return F.leaky_relu(instance_norm_2d(y), slope).to(dtype)


def _kaiming_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


class ConvNormRelu(nn.Module):
    """k3 s1 p1 by default, k4 s2 p1 when ``downsample``; no conv bias.

    ``conv_type`` is '1d' or '2d'; ``kernel_size``/``stride``/``padding``
    override the defaults (ints or per-axis tuples, torch semantics).
    """

    def __init__(self, conv_type: str, in_channels: int, out_channels: int,
                 downsample: bool = False, kernel_size=None, stride=None,
                 padding=None, norm: str = "IN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if norm != "IN":
            raise NotImplementedError(f"norm {norm!r}: only 'IN' is ported")
        if kernel_size is None:
            kernel_size, stride, padding = (4, 2, 1) if downsample else (3, 1, 1)
        conv = {"1d": nn.Conv1d, "2d": nn.Conv2d}[conv_type]
        self.conv = conv(in_channels, out_channels, kernel_size, stride, padding,
                         bias=False)
        _kaiming_normal_(self.conv.weight, generator or torch.Generator())
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
        return F.leaky_relu(channel_norm_1d(y), self.slope).to(self.dtype)
