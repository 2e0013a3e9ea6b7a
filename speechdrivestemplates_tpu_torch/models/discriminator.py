"""The LSGAN pose-sequence discriminator of s2g-GAN.

Counterpart of the JAX package's ``models/discriminator.py``
(``PoseSequenceDiscriminator``). Submodule names are the reference torch
attributes (``seq.0-2`` ConvNormRelu, ``seq.3`` the output Conv1d), so
reference-layout checkpoints load with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import ConvNormRelu, lecun_conv1d


class PoseSequenceDiscriminator(nn.Module):
    """(B, T, 2, K) poses -> (B, T') per-position real/fake scores, T' = T // 4
    for even T (two k4 s2 p1 downsamplings).

    The poses flatten to (B, 2K, T) with channel = coord * K + k, then three
    BN ConvNormRelu 1D layers (2K -> 256 k4 s2, 256 -> 512 k4 s2, 512 -> 1024
    k3 s1), leaky with ``leaky``, and a Conv1d 1024 -> 1, k3 p1, with bias,
    initialized as flax ``nn.Conv`` is. Every train-mode forward moves the BN
    running statistics, as torch BatchNorm does. ``plain`` keeps BN's plain
    layers on the card in eval mode (a reference)."""

    def __init__(self, num_keypoints: int = 121, leaky: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)

        def cnr(c_in, c_out, **kw):
            return ConvNormRelu("1d", c_in, c_out, norm="BN", leaky=leaky, dtype=dtype,
                                generator=generator, **kw)

        self.seq = nn.Sequential(
            cnr(2 * num_keypoints, 256, downsample=True), cnr(256, 512, downsample=True),
            cnr(512, 1024, kernel_size=3, stride=1, padding=1),
            lecun_conv1d(1024, 1, generator, kernel_size=3, padding=1))
        self.dtype = dtype

    @classmethod
    def from_cfg(cls, cfg, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> "PoseSequenceDiscriminator":
        dcfg = cfg.VOICE2POSE.POSE_DISCRIMINATOR
        k = len(dcfg.WHITE_LIST) if dcfg.WHITE_LIST is not None else cfg.DATASET.NUM_LANDMARKS
        return cls(k, dcfg.LEAKY_RELU, dtype, generator)

    def forward(self, poses: torch.Tensor, plain: bool = False) -> torch.Tensor:
        B, T = poses.shape[:2]
        x = poses.reshape(B, T, -1).transpose(1, 2)  # (B, 2K, T)
        for layer in self.seq[:3]:
            x = layer(x, plain)
        out = self.seq[3]
        x = F.conv1d(x, out.weight.to(self.dtype), out.bias.to(self.dtype),
                     padding=out.padding)
        return x[:, 0]
