"""Eval-mode BatchNorm, leaky ReLU and the cast to the compute dtype, in one pass.

    y = lrelu(((x - running_mean) * rsqrt(running_var + 1e-5)) * weight + bias).to(dtype)

per channel of a (B, C, H, W) or (B, C, T) activation, every step in fp32 as
the plain path rounds it (``models/blocks.py``: ``BatchNorm.forward`` in eval
mode, ``F.leaky_relu``, ``.to(dtype)``), so the kernel (``csrc/bn_act.cu``,
the op ``torch.ops.sdt.bn_act``) gives the plain path's output bit for bit,
in one read and one write of the activation where the plain path makes seven
passes. No TPU kernel: the JAX package leaves these passes to XLA, which fuses
them.

``ConvNormRelu`` calls ``bn_act`` for a BN layer in eval mode, unless it is
asked for its ``plain`` path (a reference): the kernel on the card (and on a
meta tensor, whose shape the op's fake gives), the plain path on the CPU.
Train mode keeps the plain path. The kernel has no backward: under autograd
the wrapper raises, as the IN stem's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

DTYPES = (torch.float32, torch.bfloat16)
MAX_ELEMENTS = (1 << 31) - 1  # the kernel's indices are 32-bit


def _vectors(norm) -> tuple:
    return norm.running_mean, norm.running_var, norm.weight, norm.bias


def bn_act(y: torch.Tensor, norm, slope: float) -> torch.Tensor:
    """``norm``'s eval-mode affine of ``y``, lrelu and the cast: the kernel on
    CUDA, the plain version on the CPU."""
    if y.device.type == "cpu":
        return bn_act_plain(y, norm, slope)
    return bn_act_kernel(y, norm, slope)


def bn_act_plain(y: torch.Tensor, norm, slope: float) -> torch.Tensor:
    """The plain path: ``norm`` (in eval mode here) in fp32, lrelu, the cast
    back to ``y``'s dtype."""
    return F.leaky_relu(norm(y), slope).to(y.dtype)


def bn_act_kernel(y: torch.Tensor, norm, slope: float) -> torch.Tensor:
    """``norm``'s eval-mode affine of ``y``, lrelu and the cast, by the kernel;
    the output has ``y``'s shape and dtype."""
    kernels.refuse_grad("sdt::bn_act", y, norm.weight, norm.bias)
    if y.device.type not in kernels.DEVICE_TYPES:
        raise ValueError(f"bn_act_kernel takes a CUDA tensor, got {y.device}")
    vecs = _vectors(norm)
    if (y.dtype not in DTYPES or y.ndim < 3 or y.shape[1] != norm.running_mean.numel()
            or any(t.dtype != torch.float32 for t in vecs)):
        raise ValueError(f"bn_act_kernel takes (B, {norm.running_mean.numel()}, ...) fp32 "
                         f"or bf16 and fp32 statistics, got {tuple(y.shape)} {y.dtype}, "
                         f"statistics {norm.running_mean.dtype}")
    if y.numel() > MAX_ELEMENTS:
        raise ValueError(f"bn_act_kernel takes under 2^31 elements, got {y.numel()}")
    return torch.ops.sdt.bn_act(y, *vecs, slope)


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element, how many values of a and b's dtype (bf16 or fp32) lie
    from a to b, the two signs of zero one value: how the kernel is held to
    the plain path."""
    itype, top = {torch.bfloat16: (torch.int16, 1 << 15),
                  torch.float32: (torch.int32, 1 << 31)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(itype).to(torch.int64)
        return torch.where(i < 0, -top - i, i)

    return (ordered(a) - ordered(b)).abs()
