"""The pose-sequence encoder: the frozen FGD feature encoder of Voice2Pose.

Counterpart of the JAX package's ``models/autoencoder.py::PoseSeqEncoder``,
with the reference's two quirks kept because checkpoints and metrics depend
on them: its "global pooling" takes the FIRST time position (torch's
nearest interpolation to length 1), and mu and logvar interleave, mu on the
even channels and logvar on the odd ones. Submodules are ``blocks.{0..6}``,
the reference torch names, so reference checkpoints load with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .blocks import ConvNormRelu


class PoseSeqEncoder(nn.Module):
    """(B, T, 2, K) poses -> (mu, logvar), each (B, code_dim) in the compute dtype.

    Seven 1-d ConvNormRelu: two k3 s1 at 256 channels, four k4 s2 at 256,
    and a last k4 s2 to 2 * code_dim (T = 64 -> 2 positions)."""

    def __init__(self, num_landmarks: int = 121, code_dim: int = 32,
                 norm: str = "BN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        specs = [(256, False)] * 2 + [(256, True)] * 4 + [(2 * code_dim, True)]
        blocks, c_in = [], 2 * num_landmarks
        for c_out, down in specs:
            blocks.append(ConvNormRelu("1d", c_in, c_out, downsample=down, norm=norm,
                                       leaky=leaky, dtype=dtype, generator=generator))
            c_in = c_out
        self.blocks = nn.Sequential(*blocks)
        self.dtype = dtype

    @classmethod
    def from_cfg(cls, cfg, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> "PoseSeqEncoder":
        """The frozen FGD encoder mirrors the Pose2Pose autoencoder's
        hyperparameters (POSE2POSE.AUTOENCODER)."""
        ae = cfg.POSE2POSE.AUTOENCODER
        return cls(cfg.DATASET.NUM_LANDMARKS, ae.CODE_DIM, ae.NORM, ae.LEAKY_RELU, dtype,
                   generator)

    def forward(self, poses: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, T = poses.shape[:2]
        # (B, T, 2, K) -> (B, T, 2K) -> (B, 2K, T): channel = coord * K + k
        x = self.blocks(poses.reshape(B, T, -1).transpose(1, 2))
        x = x[:, :, 0]  # nearest-interpolate to length 1 == the first position
        return x[:, 0::2], x[:, 1::2]
