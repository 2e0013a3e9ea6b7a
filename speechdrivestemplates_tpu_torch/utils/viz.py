"""Skeleton drawing for the pose videos, on the host with cv2.

The port's copy of the JAX package's ``utils/viz.py`` (the reference's
``core/utils/keypoint_visualization.py``): per-part edge lists for the 121-,
135- and 137-keypoint layouts, a frame and a clip of root-relative poses on a
white canvas, the pred | gt pair (pred at 0.33 W, gt at 0.67 W), and the
demo's filmstrip (every 8th frame on one long canvas). Frames are BGR uint8,
as cv2 writes them. cv2 is imported where a frame is drawn, so that the port
imports without it; drawing without it raises.

The offline inspectors of training data, headless (JAX's, after the
reference's interactive ``cv2.imshow`` ones): ``vis_train_npz`` draws a clip
npz's raw 137-keypoint poses, over the video frames its ``imgs`` entry names
with ``align_image``; ``vis_train_csv_dir`` does so for each clip a training csv
lists; ``vis_pose_npy`` draws one pose npy. From the command line:

    python -m speechdrivestemplates_tpu_torch.utils.viz npz <clip.npz> [-o DIR]
        [--align-image] [--max-frames N]
    python -m speechdrivestemplates_tpu_torch.utils.viz csv <data_root> <speaker>
        [-o DIR] [--align-image] [--max-frames N] [--max-clips N] [--csv PATH]

Frames go to ``frame_{i:06d}.jpg``, one directory per clip for ``csv``;
without ``-o``, under a new temporary directory.
"""

from __future__ import annotations

import os

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


def _write(cv2, path: str, img: np.ndarray) -> None:
    if not cv2.imwrite(path, img):
        raise OSError(f"cv2 could not write {path}")


def vis_train_npz(npz_path: str, out_dir=None, max_frames=None, align_image: bool = False):
    """The frames of a clip npz's (T, 3, 137) ``pose``: each skeleton on a
    flat 240-grey 720 x 1280 canvas or, with ``align_image``, over the video
    frame its ``imgs`` entry names (the canvas where that image does not
    read); the first ``max_frames`` (None: all). Written to
    ``out_dir/frame_{i:06d}.jpg`` where ``out_dir`` is given."""
    import cv2

    items = np.load(npz_path, allow_pickle=True)
    poses = items["pose"]
    imgs = items["imgs"] if align_image and "imgs" in items else None
    n = len(poses) if max_frames is None else min(max_frames, len(poses))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i in range(n):
        img = None
        if imgs is not None and i < len(imgs):
            path = imgs[i]
            path = path.decode("utf-8") if isinstance(path, bytes) else str(path)
            img = cv2.imread(path) if path else None
        if img is None:
            img = np.zeros((720, 1280, 3), dtype=np.uint8) + 240
        draw_body_parts(img, poses[i].transpose(1, 0)[:, :2], size=2)
        frames.append(img)
        if out_dir is not None:
            _write(cv2, os.path.join(out_dir, f"frame_{i:06d}.jpg"), img)
    return frames


def vis_train_csv_dir(data_root: str, speaker: str, num_kp: int = 137, out_dir=None,
                      align_image: bool = False, max_frames=None, max_clips=None,
                      csv_path=None) -> list:
    """``vis_train_npz`` of each clip a training csv lists, the first
    ``max_clips`` (None: all): the reference's
    ``<data_root>/train_<speaker>_<num_kp>_3.csv`` (absolute ``pose_fn``)
    where it exists, else ``<data_root>/<speaker>/processed_137.csv``
    (``pose_fn`` relative to the speaker directory), or ``csv_path``. A
    clip's frames go to ``out_dir/<clip name>/``. Returns the clips' paths."""
    import csv

    speaker_dir = os.path.join(data_root, speaker)
    if csv_path is None:
        csv_path = os.path.join(data_root, f"train_{speaker}_{num_kp}_3.csv")
        if not os.path.exists(csv_path):
            csv_path = os.path.join(speaker_dir, "processed_137.csv")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(csv_path)
    rendered = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            if max_clips is not None and len(rendered) >= max_clips:
                break
            npz_path = row["pose_fn"]
            if not os.path.isabs(npz_path):
                npz_path = os.path.join(speaker_dir, npz_path)
            clip_out = None
            if out_dir is not None:
                clip_out = os.path.join(out_dir,
                                        os.path.splitext(os.path.basename(npz_path))[0])
            vis_train_npz(npz_path, out_dir=clip_out, max_frames=max_frames,
                          align_image=align_image)
            rendered.append(npz_path)
    return rendered


def vis_pose_npy(npy_path: str, out_path=None) -> np.ndarray:
    """One pose npy, (3, K) or (K, >= 2), drawn on a black 720 x 1280 canvas;
    written to ``out_path`` where it is given."""
    import cv2

    pose = np.load(npy_path)
    img = np.zeros((720, 1280, 3), dtype=np.uint8)
    draw_body_parts(img, pose.T[:, :2] if pose.shape[0] == 3 else pose[:, :2])
    if out_path is not None:
        _write(cv2, out_path, img)
    return img


def main(argv=None) -> None:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="offline keypoint inspectors")
    sub = ap.add_subparsers(dest="cmd", required=True)
    npz = sub.add_parser("npz", help="render one training clip npz")
    npz.add_argument("npz_path")
    npz.add_argument("-o", "--out_dir", default=None)
    npz.add_argument("--align-image", action="store_true",
                     help="draw over the clip's original video frames")
    npz.add_argument("--max-frames", type=int, default=None)
    csv = sub.add_parser("csv", help="batch-inspect every clip in a csv")
    csv.add_argument("data_root")
    csv.add_argument("speaker")
    csv.add_argument("-o", "--out_dir", default=None)
    csv.add_argument("--align-image", action="store_true")
    csv.add_argument("--max-frames", type=int, default=None)
    csv.add_argument("--max-clips", type=int, default=None)
    csv.add_argument("--csv", dest="csv_path", default=None)
    args = ap.parse_args(argv)

    out = args.out_dir or tempfile.mkdtemp(prefix="sdt_viz_")
    if args.cmd == "npz":
        frames = vis_train_npz(args.npz_path, out_dir=out, max_frames=args.max_frames,
                               align_image=args.align_image)
        print(f"rendered {len(frames)} frames to {out}")
    else:
        clips = vis_train_csv_dir(args.data_root, args.speaker, out_dir=out,
                                  align_image=args.align_image, max_frames=args.max_frames,
                                  max_clips=args.max_clips, csv_path=args.csv_path)
        print(f"rendered {len(clips)} clips to {out}")


if __name__ == "__main__":
    main()
