"""The pose-sequence VAE: Pose2Pose's model, whose encoder is also the frozen
FGD feature encoder of Voice2Pose.

Counterpart of the JAX package's ``models/autoencoder.py`` (PoseSeqEncoder,
PoseSeqDecoder, Autoencoder), with the reference's quirks kept because
checkpoints and metrics depend on them: the encoder's "global pooling" takes
the FIRST time position (torch's nearest interpolation to length 1); mu and
logvar interleave, mu on the even channels and logvar on the odd ones; the
decoder's seed is the code repeated twice (nearest upsampling of a length-1
sequence). Submodules carry the reference torch names (``blocks.{0..6}``;
``d5..d1``, ``blocks.{0..4}``; ``encoder``, ``decoder``), so reference
checkpoints load with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import interpolate_linear_time
from .blocks import ConvNormRelu, lecun_conv1d


class PoseSeqEncoder(nn.Module):
    """(B, T, 2, K) poses -> (mu, logvar), each (B, code_dim) in the compute dtype.

    Seven 1-d ConvNormRelu: two k3 s1 at 256 channels, four k4 s2 at 256,
    and a last k4 s2 to 2 * code_dim (T = 64 -> 2 positions). ``plain`` keeps
    BN's plain layers on the card in eval mode (a reference)."""

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

    def forward(self, poses: torch.Tensor,
                plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        B, T = poses.shape[:2]
        # (B, T, 2, K) -> (B, T, 2K) -> (B, 2K, T): channel = coord * K + k
        x = poses.reshape(B, T, -1).transpose(1, 2)
        for layer in self.blocks:
            x = layer(x, plain)
        x = x[:, :, 0]  # nearest-interpolate to length 1 == the first position
        return x[:, 0::2], x[:, 1::2]


class PoseSeqDecoder(nn.Module):
    """(B, code_dim) codes -> (B, 2K, 64) poses, channel = coord * K + k.

    The code repeated twice, then ``d5..d1``, each a linear x2 upsample in time
    and a k3 ConvNormRelu to 256 channels (2 -> 64 frames), then four more
    (``blocks.0..3``) and a 1x1 conv with bias (``blocks.4``)."""

    def __init__(self, num_landmarks: int = 121, code_dim: int = 32,
                 norm: str = "BN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)

        def cnr(c_in):
            return ConvNormRelu("1d", c_in, 256, norm=norm, leaky=leaky, dtype=dtype,
                                generator=generator)

        self.d5, self.d4, self.d3, self.d2, self.d1 = (cnr(c) for c in (code_dim,) + (256,) * 4)
        self.blocks = nn.Sequential(*[cnr(256) for _ in range(4)],
                                    lecun_conv1d(256, 2 * num_landmarks, generator))
        self.dtype = dtype

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        x = code[:, :, None].expand(-1, -1, 2)
        for layer in (self.d5, self.d4, self.d3, self.d2, self.d1):
            x = layer(interpolate_linear_time(x, 2 * x.shape[-1]))
        for layer in self.blocks[:4]:
            x = layer(x)
        out = self.blocks[4]
        return F.conv1d(x, out.weight.to(self.dtype), out.bias.to(self.dtype))


class Autoencoder(nn.Module):
    """VAE: encode, reparameterize, decode (the JAX ``Autoencoder``).

    ``forward(poses, num_frames)`` -> (poses (B, num_frames, 2, K), mu, logvar).
    The reparameterization's N(0, 1) noise is ``noise`` when given, else drawn
    from ``generator`` (a ``torch.Generator`` on the poses' device). With
    ``external_code`` the encoder is bypassed: that code is decoded and
    returned as mu, with a zero logvar."""

    def __init__(self, num_landmarks: int = 121, code_dim: int = 32,
                 norm: str = "BN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.encoder = PoseSeqEncoder(num_landmarks, code_dim, norm, leaky, dtype, generator)
        self.decoder = PoseSeqDecoder(num_landmarks, code_dim, norm, leaky, dtype, generator)
        self.num_landmarks = num_landmarks

    @classmethod
    def from_cfg(cls, cfg, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> "Autoencoder":
        ae = cfg.POSE2POSE.AUTOENCODER
        return cls(cfg.DATASET.NUM_LANDMARKS, ae.CODE_DIM, ae.NORM, ae.LEAKY_RELU, dtype,
                   generator)

    def forward(self, poses: Optional[torch.Tensor], num_frames: int,
                external_code: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if external_code is not None:
            mu, logvar = external_code, torch.zeros_like(external_code)
            code = external_code
        else:
            mu, logvar = self.encoder(poses)
            if noise is None:
                noise = torch.randn(logvar.shape, generator=generator, device=logvar.device,
                                    dtype=logvar.dtype)
            code = mu + torch.exp(0.5 * logvar) * noise.to(logvar.dtype)
        x = self.decoder(code)
        # (B, 2K, T) -> (B, T, 2K) -> (B, T, 2, K)
        return x.transpose(1, 2).reshape(x.shape[0], num_frames, 2, self.num_landmarks), \
            mu, logvar
