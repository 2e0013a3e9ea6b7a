"""The audio encoder's stem: its first three IN-normalized ConvNormRelu layers.

    conv1 1->64 k3 s1 p1, IN1, lrelu
    conv2 64->64 k4 s2 p1, IN2, lrelu
    conv3 64->128 k3 s1 p1, IN3, lrelu

``audio_encoder_stem`` is the entry: on a CUDA tensor it runs conv1 + IN1 in
the fused conv1 kernel (``ops/conv1.py``, ``csrc/conv1.cu``) and the rest, the
stem's tail, in the fused stem kernel (``csrc/stem.cu``, the op
``torch.ops.sdt.stem``), and raises if it cannot; on a CPU tensor it runs
``stem_plain``, the port's own three ConvNormRelu layers. Both return the JAX
package's layout, (B, 40, W2, 128) with W2 = (W1 - 2) // 2 + 1, in the compute
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from ..kernels.ops import C1, C3, stem_dims
from ..models.blocks import conv_norm_relu_2d, instance_norm_2d
from . import conv1 as conv1_ops


def stem_plain(mel: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               w3: torch.Tensor, slope: float = 0.2,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """mel (B, 80, W1) -> (B, 40, W2, 128); w1/w2/w3 are OIHW conv weights."""
    x = mel[:, None]
    x = conv_norm_relu_2d(x, w1, 1, 1, slope, dtype)
    x = conv_norm_relu_2d(x, w2, 2, 1, slope, dtype)
    x = conv_norm_relu_2d(x, w3, 1, 1, slope, dtype)
    return x.permute(0, 2, 3, 1)


def stem_tail_plain(y1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                    slope: float = 0.2, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """conv2 + IN2 + conv3 + IN3 on conv1's h-padded activation (B, 82, W1, 64)
    from ``fused_conv1_in`` -> (B, 40, W2, 128): conv2 with padding (0, 1)."""
    x = y1.permute(0, 3, 1, 2)
    x = F.conv2d(x.to(dtype), w2.to(dtype), stride=2, padding=(0, 1))
    x = F.leaky_relu(instance_norm_2d(x), slope).to(dtype)
    return conv_norm_relu_2d(x, w3, 1, 1, slope, dtype).permute(0, 2, 3, 1)


def stem_tail_kernel(y1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                     slope: float = 0.2, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[conv2, IN2, conv3, IN3] (the fused stem kernel) on conv1's padded
    activation; same contract as ``stem_tail_plain``. Forward-only: raises for
    an input that requires grad under grad mode."""
    kernels.refuse_grad("the stem kernel", y1, w2, w3)
    dev = y1.device
    if dev.type not in kernels.DEVICE_TYPES:
        raise ValueError("stem kernel takes CUDA tensors")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem kernel computes in float32 or bfloat16, not {dtype}")
    rows = conv1_ops.ROWS
    if y1.ndim != 4 or y1.shape[1] != rows or y1.shape[3] != C1 or y1.dtype != dtype:
        raise ValueError(f"expected a {dtype} activation (B, {rows}, W1, {C1}), got "
                         f"{y1.dtype} {tuple(y1.shape)}")
    W1 = y1.shape[2]
    if W1 < 2:
        raise ValueError(f"mel width {W1} is too short for the stem")
    for w, shape in ((w2, (C1, C1, 4, 4)), (w3, (C3, C1, 3, 3))):
        if tuple(w.shape) != shape or w.device != dev:
            raise ValueError(f"stem weight {tuple(w.shape)} on {w.device}: "
                             f"expected {shape} on {dev}")
    # conv weights as (kh, kw, C_out, C_in) in the compute dtype
    w2t = w2.to(dtype).permute(2, 3, 0, 1).contiguous()
    w3t = w3.to(dtype).permute(2, 3, 0, 1).contiguous()
    return torch.ops.sdt.stem(y1, w2t, w3t, float(slope))


def stem_kernel(mel: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                w3: torch.Tensor, slope: float = 0.2,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fused conv1 kernel, then the fused stem kernel: no PyTorch op between."""
    y1 = conv1_ops.conv1_in_kernel(mel, w1, slope, dtype)
    return stem_tail_kernel(y1, w2, w3, slope, dtype)


def audio_encoder_stem(mel: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                       w3: torch.Tensor, slope: float = 0.2,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The stem: the kernel on CUDA, the plain version on the CPU."""
    if mel.device.type == "cpu":
        return stem_plain(mel, w1, w2, w3, slope, dtype)
    return stem_kernel(mel, w1, w2, w3, slope, dtype)
