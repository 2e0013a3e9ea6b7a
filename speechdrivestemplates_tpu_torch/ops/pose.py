"""Keypoint-space transforms on (..., C, K) tensors (C = 2 coords, K = 121).

Keypoint layout (reference pose_definition.md):
  0..8    upper body (root/neck kp already removed)
  9..78   face (70)
  79..99  left hand (21), 100..120 right hand (21)
Hierarchical ("parted") space re-roots the face at HEAD_ROOT and each hand at
its wrist anchor; ``parted_to_global`` undoes that with a gather and an FMA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HAND_ROOT_L = 6
HAND_ROOT_R = 3
HEAD_ROOT = 39


def _build_reroot_tables(num_kp: int = 121):
    """For each keypoint: the index of its part root, and 1.0 if it is re-rooted.

    parted = global - coords[ROOT_INDEX] * MASK;  global = parted + same.
    Face kps (9..78 except HEAD_ROOT) root at HEAD_ROOT; kps 79:100 at
    HAND_ROOT_L; 100:121 at HAND_ROOT_R.
    """
    root_index = np.arange(num_kp, dtype=np.int32)
    mask = np.zeros(num_kp, dtype=np.float32)
    head_members = list(range(9, HEAD_ROOT)) + list(range(HEAD_ROOT + 1, 79))
    root_index[head_members] = HEAD_ROOT
    mask[head_members] = 1.0
    root_index[79:100] = HAND_ROOT_L
    mask[79:100] = 1.0
    root_index[100:121] = HAND_ROOT_R
    mask[100:121] = 1.0
    return root_index, mask


@functools.lru_cache(maxsize=8)
def _reroot_tensors(device: torch.device):
    index, mask = _build_reroot_tables()
    return (torch.from_numpy(index.astype(np.int64)).to(device),
            torch.from_numpy(mask).to(device))


def denormalize_poses(kp, mean, std, num_landmarks: int = 121):
    """Inverse per-speaker z-score of (B, T, 2, K) poses; mean/std (B, 2K)."""
    shape = (mean.shape[0], 1, 2, num_landmarks)
    return kp * std.reshape(shape) + mean.reshape(shape)


def parted_to_global(poses: torch.Tensor) -> torch.Tensor:
    """Hierarchical -> global relative poses: add each part root's coordinates."""
    index, mask = _reroot_tensors(poses.device)
    xy = poses[..., :2, :]
    xy = xy + xy[..., index] * mask
    if poses.shape[-2] > 2:
        return torch.cat([xy, poses[..., 2:, :]], dim=-2)
    return xy


def get_final_results(poses, mean, std, scale_factor, hierarchical: bool,
                      num_landmarks: int = 121):
    """Denormalize -> (optionally) re-root to global -> scale to pixels.

    ``poses``: (B, T, 2, K); ``mean``/``std``: (B, 242); ``scale_factor``: (B,).
    """
    poses = denormalize_poses(poses, mean, std, num_landmarks)
    if hierarchical:
        poses = parted_to_global(poses)
    return poses * scale_factor.reshape(-1, 1, 1, 1)
