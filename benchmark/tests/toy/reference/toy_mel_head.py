"""The toy architecture's plain float32 math: the power mel resized to the
video frames, then a 1x1 projection to the pose coordinates with a gain and
a bias on each output channel."""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def forward(p: Dict[str, torch.Tensor], mel: torch.Tensor, num_frames: int,
            num_landmarks: int, quant: Optional[Callable] = None) -> torch.Tensor:
    """mel (B, 80, T_mel) -> normalized poses (B, num_frames, 2, num_landmarks)."""
    q = quant or (lambda t: t)
    x = F.interpolate(mel.float(), size=num_frames, mode="linear", align_corners=False)
    y = F.conv1d(q(x), q(p["proj.weight"][:, :, None]))
    y = y * p["proj.gain"][:, None] + p["proj.bias"][:, None]
    return y.transpose(1, 2).reshape(y.shape[0], num_frames, 2, num_landmarks)
