"""Skeleton drawing for the pose videos, on the host with cv2.

The port's copy of the JAX package's ``utils/viz.py`` (the reference's
``core/utils/keypoint_visualization.py``): per-part edge lists for the 121-,
135- and 137-keypoint layouts, a frame and a clip of root-relative poses on a
white canvas, the pred | gt pair (pred at 0.33 W, gt at 0.67 W), and the
demo's filmstrip (every 8th frame on one long canvas). Frames are BGR uint8,
as cv2 writes them. cv2 is imported where a frame is drawn, so that the port
imports without it; drawing without it raises.
"""

from __future__ import annotations

import numpy as np

HAND_EDGES = [
    [[0, 1], [1, 2], [2, 3], [3, 4]],
    [[0, 5], [5, 6], [6, 7], [7, 8]],
    [[0, 9], [9, 10], [10, 11], [11, 12]],
    [[0, 13], [13, 14], [14, 15], [15, 16]],
    [[0, 17], [17, 18], [18, 19], [19, 20]],
]

FACE_EDGES = (
    [[i, i + 1] for i in range(16)]
    + [[17, 18], [18, 19], [19, 20], [20, 21]]
    + [[22, 23], [23, 24], [24, 25], [25, 26]]
    + [[27, 28], [28, 29], [29, 30]]
    + [[31, 32], [32, 33], [33, 34], [34, 35]]
    + [[36, 37], [37, 38], [38, 39], [39, 40], [40, 41], [41, 36]]
    + [[42, 43], [43, 44], [44, 45], [45, 46], [46, 47], [47, 42]]
    + [[48, 49], [49, 50], [50, 51], [51, 52], [52, 53], [53, 54], [54, 55],
       [55, 56], [56, 57], [57, 58], [58, 59], [59, 48]]
    + [[60, 61], [61, 62], [62, 63], [63, 64], [64, 65], [65, 66], [66, 67], [67, 60]]
)

# (number of body keypoints, body edges) of each layout
_LAYOUTS = {
    135: (23, [[0, 1], [0, 4], [1, 2], [4, 5], [2, 3], [5, 6]]),
    137: (25, [[1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7]]),
    121: (9, [[1, 4], [1, 2], [2, 3], [4, 5], [5, 6]]),
}
_NUM_HAND, _NUM_FACE = 21, 70


def _draw_edges(cv2, img, kps, edges, color, size):
    for e in edges:
        p0 = (int(kps[e[0]][0]), int(kps[e[0]][1]))
        p1 = (int(kps[e[1]][0]), int(kps[e[1]][1]))
        cv2.line(img, p0, p1, color, size, cv2.LINE_AA)
    return img


def _draw_hand(cv2, img, kps, size):
    for idx, edges in enumerate(HAND_EDGES):
        color_lvl = 255 / 8 * (idx + 3)
        _draw_edges(cv2, img, kps, edges, (255, color_lvl, 1 - color_lvl), size)
    return img


def draw_body_parts(img: np.ndarray, landmarks: np.ndarray, size: int = 2) -> np.ndarray:
    """Draw a skeleton into ``img`` in place; ``landmarks``: (K, 2) pixels."""
    import cv2

    num_kp = landmarks.shape[0]
    if num_kp not in _LAYOUTS:
        raise ValueError(f"Unsupported number of keypoints: {num_kp} (121, 135 or 137)")
    num_pose, pose_edges = _LAYOUTS[num_kp]
    face0, hand0 = num_pose, num_pose + _NUM_FACE
    _draw_edges(cv2, img, landmarks[:num_pose], pose_edges, (25, 175, 25), size + 2)
    _draw_edges(cv2, img, landmarks[face0:hand0], FACE_EDGES, (100, 100, 100), size)
    _draw_hand(cv2, img, landmarks[hand0:hand0 + _NUM_HAND], size + 1)
    _draw_hand(cv2, img, landmarks[hand0 + _NUM_HAND:hand0 + 2 * _NUM_HAND], size + 1)
    return img


def _blank(canvas_size) -> np.ndarray:
    h, w = canvas_size
    return np.zeros([h, w, 3], dtype=np.uint8) + 255


def vis_relative_pose(relative_pose: np.ndarray, canvas_size) -> np.ndarray:
    """(2, K) root-relative pose -> (H, W, 3) frame, the root at the centre."""
    h, w = canvas_size
    return draw_body_parts(_blank(canvas_size), relative_pose.T + np.array([[w // 2, h // 2]]))


def vis_relative_pose_clip(relative_poses: np.ndarray, canvas_size) -> np.ndarray:
    """(T, 2, K) -> (T, H, W, 3) uint8."""
    return np.array([vis_relative_pose(p, canvas_size) for p in relative_poses])


def vis_relative_pose_pair(pred: np.ndarray, gt: np.ndarray, canvas_size) -> np.ndarray:
    """Two (2, K) poses on one frame: ``pred`` at 0.33 W, ``gt`` at 0.67 W."""
    h, w = canvas_size
    img = _blank(canvas_size)
    draw_body_parts(img, pred.T + np.array([[int(w * 0.33), h // 2]]))
    draw_body_parts(img, gt.T + np.array([[int(w * 0.67), h // 2]]))
    return img


def vis_relative_pose_pair_clip(preds: np.ndarray, gts: np.ndarray, canvas_size) -> np.ndarray:
    """(T, 2, K) twice -> (T, H, W, 3) uint8."""
    return np.array([vis_relative_pose_pair(p, g, canvas_size) for p, g in zip(preds, gts)])


def draw_pose_frames_in_long_img(poses: np.ndarray) -> np.ndarray:
    """(T, K, 2) -> one 720-pixel-high filmstrip of every 8th frame."""
    n = poses.shape[0]
    interval = 8
    poses = poses[: n - n % interval + 1]
    n = poses.shape[0] // interval + 1
    h = 720
    w = h // 3 * 4
    pose_step = h * 0.7
    canvas = np.zeros([h, w + int((n - 1) * pose_step), 3], dtype=np.uint8) + 255
    for i in range(0, poses.shape[0], interval):
        x0 = int(i // interval * pose_step)
        draw_body_parts(canvas[:, x0: x0 + w, :], poses[i] + np.array([[w // 2, h // 2]]))
    return canvas
