"""Eval-mode InstanceNorm, leaky ReLU and the cast to the compute dtype, in one pass.

    y = lrelu((x - mean) * rsqrt(var + 1e-5)).to(dtype)

with the biased mean and variance of each (b, c) plane over (H, W) of a
(B, C, H, W) activation (``models/blocks.py::instance_norm_2d``), or of each
(b, t) column over C of a (B, C, T) one (the reference's IN-1d,
``channel_norm_1d``), taken in fp32 from the activation's values. The kernel
(``csrc/in_act.cu``, the op ``torch.ops.sdt.in_act``) reads the activation
once and writes it once where the plain path makes six passes; its
statistics sum in another order than ``var_mean``, so an output lies within
one bf16 ulp of the plain path's plus that fp32 round-off (which near a
column's mean, where x - mean cancels, is many bf16 ulps of a value near 0).
No TPU kernel: the JAX package leaves these passes to XLA, which fuses them.

``ConvNormRelu`` calls ``in_act`` for an IN layer in eval mode, unless it is
asked for its ``plain`` path (a reference): the kernel on the card (and on a
meta tensor, whose shape the op's fake gives), the plain path on the CPU.
Train mode keeps the plain path, and an IN audio encoder's first three
layers run in the stem (``ops/stem.py``). The kernel has no backward: under
autograd the wrapper raises, as the IN stem's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels.ops import in_act_slab

DTYPES = (torch.float32, torch.bfloat16)
MAX_SLAB = (1 << 31) - 1  # the kernel's indices inside one sample's slab are 32-bit


def in_act(y: torch.Tensor, slope: float) -> torch.Tensor:
    """The IN, lrelu and cast of ``y``: the kernel on CUDA, the plain version
    on the CPU."""
    if y.device.type == "cpu":
        return in_act_plain(y, slope)
    return in_act_kernel(y, slope)


def in_act_plain(y: torch.Tensor, slope: float) -> torch.Tensor:
    """The plain path: the 2-D IN of a (B, C, H, W) or the 1-D channel norm
    of a (B, C, T) in fp32, lrelu, the cast back to ``y``'s dtype."""
    from ..models.blocks import channel_norm_1d, instance_norm_2d  # blocks imports this module

    norm = instance_norm_2d if y.ndim == 4 else channel_norm_1d
    return F.leaky_relu(norm(y), slope).to(y.dtype)


def _checked(y: torch.Tensor) -> None:
    kernels.refuse_grad("sdt::in_act", y)
    if y.device.type not in kernels.DEVICE_TYPES:
        raise ValueError(f"in_act_kernel takes a CUDA tensor, got {y.device}")
    if y.dtype not in DTYPES or y.ndim not in (3, 4):
        raise ValueError(f"in_act_kernel takes (B, C, H, W) or (B, C, T) fp32 or bf16, got "
                         f"{tuple(y.shape)} {y.dtype}")
    slab = in_act_slab(y)
    if slab is None:
        raise ValueError(f"in_act_kernel takes a channels-last or contiguous activation, got "
                         f"shape {tuple(y.shape)} strides {y.stride()}")
    if slab[1] * slab[2] > MAX_SLAB:
        raise ValueError(f"in_act_kernel takes under 2^31 elements a sample, got "
                         f"{slab[1] * slab[2]}")


def in_act_kernel(y: torch.Tensor, slope: float) -> torch.Tensor:
    """The IN, lrelu and cast of ``y`` by the kernel; the output has ``y``'s
    shape, strides and dtype."""
    _checked(y)
    return torch.ops.sdt.in_act(y, float(slope))


def in_act_kernel_stats(y: torch.Tensor, slope: float):
    """``in_act_kernel``'s output, and the fp32 mean and biased variance it
    normalized with: (B, C) of a 2-D activation, (B, T) of a 1-D one."""
    _checked(y)
    return torch.ops.sdt.in_act_stats(y, float(slope))
