"""The speech encoder's feature-encoder norm in one pass: the convolution's
bias, the LayerNorm over the channels, the exact GELU and the cast.

    y = gelu((x + bias - mean) * rsqrt(var + eps) * weight + beta).to(dtype)

for each row of a (..., C) activation (the feature encoder's (B, T, C) layer
output, its convolution taken without the bias), with the mean and biased
variance of ``x + bias`` over the row's C channels, all in fp32 and rounded
once. The kernel (``csrc/ln_gelu.cu``, the op ``torch.ops.sdt.ln_gelu``)
reads the activation once and writes it once where the plain composition
(the convolution with its bias, ``F.layer_norm``, ``F.gelu``) makes three
passes, each rounding to the compute dtype; its statistics sum in another
order than ``F.layer_norm``'s, so an output lies within one bf16 ulp of
``ln_gelu_plain``'s plus that fp32 round-off. No TPU kernel: the JAX package
has no speech encoder.

``SpeechEncoder.forward`` (``models/speech_encoder.py``) calls
``ln_gelu_kernel`` in a forward that takes no gradient (eval mode, autograd
off) on a card's tensor (or a meta tensor, whose shape the op's fake gives),
unless it is asked for its ``plain`` path. The CPU, train mode, autograd and
``plain`` keep the plain composition; ``ln_gelu_plain`` is the reference the
tests hold the kernel to. The kernel has no backward: under autograd the
wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 1024  # csrc/ln_gelu.cu MAX_C: 32 values a lane
MAX_ROWS = (1 << 31) - 1  # the kernel's row count is 32-bit


def ln_gelu_plain(x: torch.Tensor, bias: torch.Tensor, weight: torch.Tensor,
                  beta: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x + bias``, ``F.layer_norm``
    and ``F.gelu`` in fp32, then the cast back to ``x``'s dtype."""
    v = x.float() + bias.float()
    y = F.layer_norm(v, (v.shape[-1],), weight.float(), beta.float(), eps)
    return F.gelu(y).to(x.dtype)


def ln_gelu_kernel(x: torch.Tensor, bias: torch.Tensor, weight: torch.Tensor,
                   beta: torch.Tensor, eps: float) -> torch.Tensor:
    """The bias, LayerNorm, GELU and cast of ``x`` by the kernel; the output
    has ``x``'s shape and dtype, contiguous."""
    kernels.refuse_grad("sdt::ln_gelu", x, bias, weight, beta)
    if x.device.type not in kernels.DEVICE_TYPES:
        raise ValueError(f"ln_gelu_kernel takes a CUDA tensor, got {x.device}")
    c = x.shape[-1] if x.ndim else 0
    if (x.dtype not in DTYPES or x.ndim < 2
            or any(t.dtype != x.dtype or tuple(t.shape) != (c,) for t in (bias, weight, beta))):
        raise ValueError(f"ln_gelu_kernel takes (..., C) fp32 or bf16 rows and a bias, weight "
                         f"and beta of (C,) in their dtype, got {tuple(x.shape)} {x.dtype}, "
                         f"{[(tuple(t.shape), t.dtype) for t in (bias, weight, beta)]}")
    if c % 8 or not 8 <= c <= MAX_CHANNELS:
        raise ValueError(f"ln_gelu_kernel takes C a multiple of 8 from 8 to {MAX_CHANNELS}, "
                         f"got {c}")
    if not x.is_contiguous() or x.storage_offset() * x.element_size() % 16:
        raise ValueError(f"ln_gelu_kernel takes dense rows at a 16-byte boundary, got shape "
                         f"{tuple(x.shape)} strides {x.stride()} offset {x.storage_offset()}")
    if x.numel() // c > MAX_ROWS:
        raise ValueError(f"ln_gelu_kernel takes under 2^31 rows, got {x.numel() // c}")
    return torch.ops.sdt.ln_gelu(x, bias, weight, beta, float(eps))
