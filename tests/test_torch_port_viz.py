"""The port's skeleton drawing (``utils/viz.py``) and epoch figure against the
JAX package's: frames equal as uint8, bit for bit, for seeded poses in the
121-, 135- and 137-keypoint layouts, for a clip, a pred | gt pair and the
demo's filmstrip; ``_pca_2d`` and the ``clip_code`` figure's pixels equal
JAX's for an SDT-BP bank, a frame-variant bank and a Pose2Pose bank. Small
canvases (180, 320) and 8 frames, as the JAX package's own viz tests."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu.utils import viz as jax_viz
from speechdrivestemplates_tpu_torch.utils import viz

CANVAS = (180, 320)


def _poses(k, seed=0, t=8):
    return (np.random.RandomState(seed).randn(t, 2, k) * 60).astype(np.float32)


@pytest.mark.parametrize("k", [121, 135, 137])
@pytest.mark.parametrize("what", ["clip", "pair", "filmstrip"])
def test_frames_equal_the_jax_frames(k, what):
    p, g = _poses(k, 1), _poses(k, 2)
    if what == "clip":
        got, want = viz.vis_relative_pose_clip(p, CANVAS), jax_viz.vis_relative_pose_clip(p, CANVAS)
        assert got.shape == (8, *CANVAS, 3)
    elif what == "pair":
        got = viz.vis_relative_pose_pair_clip(p, g, CANVAS)
        want = jax_viz.vis_relative_pose_pair_clip(p, g, CANVAS)
        assert got.shape == (8, *CANVAS, 3)
    else:
        got = viz.draw_pose_frames_in_long_img(p.transpose(0, 2, 1))
        want = jax_viz.draw_pose_frames_in_long_img(p.transpose(0, 2, 1))
        assert got.shape[0] == 720
    assert got.dtype == want.dtype == np.uint8
    assert (got < 250).any()  # a skeleton was drawn
    np.testing.assert_array_equal(got, want)


def test_unsupported_layout_raises():
    with pytest.raises(ValueError, match="Unsupported number of keypoints: 99"):
        viz.draw_body_parts(np.zeros((10, 10, 3), np.uint8), np.zeros((99, 2)))


def test_pca_2d_equals_the_jax_one():
    from speechdrivestemplates_tpu.pipelines.voice2pose import _pca_2d as jax_pca
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import _pca_2d

    x = np.random.RandomState(3).randn(40, 32).astype(np.float32)
    np.testing.assert_array_equal(_pca_2d(x), jax_pca(x))


def _pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("bank", ["sdt_bp", "frame_variant", "pose2pose"])
def test_clip_code_figure_equals_the_jax_figure(bank):
    """The port's figure (an Agg canvas of its own) and JAX's (pyplot) have
    the same pixels for the same bank."""
    from speechdrivestemplates_tpu.pipelines import pose2pose as jax_p2p
    from speechdrivestemplates_tpu.pipelines import voice2pose as jax_v2p
    from speechdrivestemplates_tpu_torch.pipelines import pose2pose, voice2pose

    rng = np.random.RandomState(4)
    shape = {"sdt_bp": (24, 32), "frame_variant": (6, 32, 8), "pose2pose": (24, 32)}[bank]
    code = rng.randn(*shape).astype(np.float32)
    if bank == "pose2pose":
        state = SimpleNamespace(clip_code_mu=torch.from_numpy(code))
        got = pose2pose.draw_figure_epoch(state)
        jcfg = SimpleNamespace(POSE2POSE=SimpleNamespace(AUTOENCODER=SimpleNamespace(CODE_DIM=32)))
        want = jax_p2p.Pose2Pose.draw_figure_epoch(
            SimpleNamespace(cfg=jcfg, state={"clip_code_mu": code}))
    else:
        got = voice2pose.draw_figure_epoch(SimpleNamespace(clips_code=torch.from_numpy(code)))
        want = jax_v2p.Voice2Pose.draw_figure_epoch(
            SimpleNamespace(has_code=True, state={"clips_code": code}))
    assert list(got) == list(want) == ["clip_code"]
    np.testing.assert_array_equal(_pixels(got["clip_code"]), _pixels(want["clip_code"]))
    assert voice2pose.draw_figure_epoch(SimpleNamespace(clips_code=None)) == {}
