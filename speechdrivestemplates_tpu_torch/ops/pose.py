"""Keypoint-space transforms on (..., C, K) tensors (C = 2 coords, K = 121).

Keypoint layout (reference pose_definition.md):
  0..8    upper body (root/neck kp already removed)
  9..78   face (70)
  79..99  left hand (21), 100..120 right hand (21)
Hierarchical ("parted") space re-roots the face at HEAD_ROOT and each hand at
its wrist anchor; ``parted_to_global`` undoes that with a gather and an FMA.

The dataset's transforms (137 raw keypoints -> normalized parted poses) are
numpy and run in the loader; the rest are torch and run in the train step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel import dist as pdist

HAND_ROOT_L = 6
HAND_ROOT_R = 3
HEAD_ROOT = 39
ROOT_NODE_122 = 1  # the root's index in keypoint-122 space
LIP_UPPER, LIP_LOWER = 71, 75  # the keypoints of the lip-sync metric

# 137 -> 122: drop the lower body; 122 -> 121: drop the root node
KP_137_TO_122 = np.array(list(range(0, 8)) + [15, 16] + list(range(25, 137)), np.int32)
KP_122_TO_121 = np.array([0] + list(range(2, 122)), np.int32)


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


def remove_unused_kp(poses: np.ndarray) -> np.ndarray:
    """(..., C, 137) -> (..., C, 122): drop the lower-body keypoints."""
    if poses.shape[-1] != 137:
        raise ValueError(f"expected 137 keypoints, got {poses.shape[-1]}")
    return poses[..., :, KP_137_TO_122]


def absolute_to_relative(poses: np.ndarray) -> np.ndarray:
    """(..., C, 122) -> (..., C, 121): x, y centred on the root node, which is
    dropped; a score row passes through."""
    xy = poses[..., :2, :] - poses[..., :2, ROOT_NODE_122, None]
    if poses.shape[-2] > 2:
        xy = np.concatenate([xy, poses[..., 2:, :]], axis=-2)
    return xy[..., :, KP_122_TO_121]


def global_to_parted(poses: np.ndarray) -> np.ndarray:
    """Global -> hierarchical relative poses: subtract each part root's x, y."""
    index, mask = _build_reroot_tables()
    xy = poses[..., :2, :]
    xy = xy - xy[..., :, index] * mask
    if poses.shape[-2] > 2:
        return np.concatenate([xy, poses[..., 2:, :]], axis=-2)
    return xy


def normalize_poses(kp: np.ndarray, mean: np.ndarray, std: np.ndarray,
                    num_landmarks: int = 121) -> np.ndarray:
    """Per-speaker z-score of (T, 2, K) poses; mean/std (2K,)."""
    return (kp - mean.reshape(1, 2, num_landmarks)) / std.reshape(1, 2, num_landmarks)


@functools.lru_cache(maxsize=8)
def _reroot_tensors(device: torch.device):
    index, mask = _build_reroot_tables()
    with torch.inference_mode(False):  # cached: usable outside inference mode too
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


def transform_normalized_parted2global(poses, parted_mean, parted_std, global_mean,
                                       global_std, num_landmarks: int = 121):
    """Parted-normalized (B, T, 2, K) poses -> global-normalized ones, the FGD
    pose encoder's input when training on global poses (the JAX function of
    this name); each statistic (B, 2K)."""
    poses = parted_to_global(denormalize_poses(poses, parted_mean, parted_std, num_landmarks))
    shape = (global_mean.shape[0], 1, 2, num_landmarks)
    return (poses - global_mean.reshape(shape)) / global_std.reshape(shape)


def get_final_results(poses, mean, std, scale_factor, hierarchical: bool,
                      num_landmarks: int = 121):
    """Denormalize -> (optionally) re-root to global -> scale to pixels.

    ``poses``: (B, T, 2, K); ``mean``/``std``: (B, 242); ``scale_factor``: (B,).
    """
    poses = denormalize_poses(poses, mean, std, num_landmarks)
    if hierarchical:
        poses = parted_to_global(poses)
    return poses * scale_factor.reshape(-1, 1, 1, 1)


def step_metrics(pred: torch.Tensor, gt: torch.Tensor, multiple: int = 1) -> dict:
    """A step's metrics on final (pixel-space) poses (B, T, 2, K):
    ``L2_dist``, the mean keypoint distance, and ``lip_sync_error_n``, the
    mean gap of the lip openings normalized by each clip's widest true one.
    A batch of ``multiple`` > 1 repeats (``multiply_batch``) also gives the
    least and the largest of the repeats' mean distances, ``L2_dist_min`` and
    ``L2_dist_max``. Under a process group each mean is the global batch's
    (the mean over ranks of equal-sized shards' means)."""
    l2 = torch.linalg.vector_norm(pred - gt, dim=2)
    lip_pred = torch.linalg.vector_norm(pred[..., LIP_LOWER] - pred[..., LIP_UPPER], dim=-1)
    lip_gt = torch.linalg.vector_norm(gt[..., LIP_LOWER] - gt[..., LIP_UPPER], dim=-1)
    denom = lip_gt.amax(-1, keepdim=True) + 1e-4
    lip_err = (lip_pred / denom - lip_gt / denom).abs()
    out = {"L2_dist": pdist.mean_over_ranks(l2.mean()),
           "lip_sync_error_n": pdist.mean_over_ranks(lip_err.mean())}
    if multiple > 1:
        per = pdist.mean_over_ranks(l2.reshape(multiple, -1).mean(1))
        out["L2_dist_min"], out["L2_dist_max"] = per.min(), per.max()
    return out


def multiply_batch(batch, multiple: int):
    """A batch (nested dicts of tensors) repeated ``multiple`` times along the
    leading axis, the whole batch after itself (the JAX ``multiply_batch``)."""
    if isinstance(batch, dict):
        return {k: multiply_batch(v, multiple) for k, v in batch.items()}
    return batch.repeat(multiple, *([1] * (batch.ndim - 1)))
