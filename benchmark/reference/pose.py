"""Normalized poses -> pixel-space poses, the reference repository's
``get_final_results``: undo the speaker's z-score, re-root the face at
keypoint 39 and each hand at its wrist (keypoints 6 and 3) where the poses
are hierarchical, and scale by the speaker's factor. Keypoints 9-78 but 39
are the face, 79-99 the left hand, 100-120 the right."""

import json
import os
from typing import Dict

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def speaker_stat(speaker: str, parted: bool) -> Dict[str, np.ndarray]:
    """A frozen copy of the speaker's statistics: mean, std (242,), scale_factor."""
    with open(os.path.join(HERE, f"speaker_{speaker}.json")) as f:
        table = json.load(f)["parted" if parted else "global"]
    return {"mean": np.asarray(table["mean"], np.float32),
            "std": np.asarray(table["std"], np.float32),
            "scale_factor": np.float32(table["scale_factor"])}


def reroot_tables(num_kp: int = 121):
    root = np.arange(num_kp)
    mask = np.zeros(num_kp, np.float32)
    face = [k for k in range(9, 79) if k != 39]
    root[face], mask[face] = 39, 1.0
    root[79:100], mask[79:100] = 6, 1.0
    root[100:121], mask[100:121] = 3, 1.0
    return root, mask


def final_poses(poses: torch.Tensor, stat: Dict[str, np.ndarray], hierarchical: bool
                ) -> torch.Tensor:
    """(B, T, 2, K) normalized -> pixel space, float32, one speaker's statistics."""
    dev, k = poses.device, poses.shape[-1]
    mean = torch.from_numpy(stat["mean"]).to(dev).view(1, 1, 2, k)
    std = torch.from_numpy(stat["std"]).to(dev).view(1, 1, 2, k)
    x = poses.float() * std + mean
    if hierarchical:
        root, mask = reroot_tables(k)
        x = x + x[..., torch.from_numpy(root).to(dev)] * torch.from_numpy(mask).to(dev)
    return x * float(stat["scale_factor"])
