"""The SDT-BP demo's routes against the JAX package's, on the CPU, with one
seeded ``.pth`` loaded by both: the port's dense demo, which runs each clip at
its own length, against JAX's bucketed and exact-length dense demos (fp32, and
bf16 by the bf16 quantile gate), and the windowed demo.
Codes are fixed by DEMO.CODE_INDEX: the port cannot reproduce a JAX draw."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
from speechdrivestemplates_tpu_torch.pipelines import voice2pose as V

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
OPTS = ["DEMO.CODE_INDEX", "1", "TEST.SAVE_VIDEO", "False", "DATASET.MAX_DEMO_LENGTH", "None"]
PX_ATOL = 0.01  # px: the bound of tests/test_demo_bucketing.py


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.pipelines import get_pipeline

    tmp = tmp_path_factory.mktemp("demo_forward")
    state = V.Voice2PoseTrainState(apply_overrides(sdt_bp(precision="fp32"), list(OPTS)), 4,
                                   "cpu")
    with torch.no_grad():
        state.clips_code.copy_(torch.from_numpy(
            np.random.RandomState(2).randn(4, 32).astype(np.float32)))
    ckpt = str(tmp / "bp.pth")
    state.save_checkpoint(ckpt, 1, 1)

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.merge_from_list(["DATASET.SPEAKER", "oliver", "SYS.MESH.DATA", "1", *OPTS])
    cfg.freeze()
    pipe = get_pipeline("Voice2Pose")(cfg)
    pipe.num_train_samples = None  # a demo takes the checkpoint's bank rows
    pipe._load_model_weights(ckpt)
    return dict(tmp=tmp, ckpt=ckpt, pipe=pipe)


def _port_state(setup, precision="fp32", *opts):
    state = V.Voice2PoseTrainState(apply_overrides(sdt_bp(precision=precision),
                                                   [*OPTS, *opts]), None, "cpu")
    state.load_pth(setup["ckpt"])
    return state


def _jax_bucket(pipe, bucket_s):
    pipe.cfg.defrost()
    pipe.cfg.DEMO.LENGTH_BUCKET_S = bucket_s
    pipe.cfg.freeze()


def _batches(setup, seconds, seed=0):
    """The same wav through both packages' demo splits: (port batch, JAX batch)."""
    path = str(setup["tmp"] / f"clip_{seconds}.wav")
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = sum(0.05 * np.sin(2 * np.pi * f * t + rng.rand() * 6) for f in (120, 240, 480, 950))
    x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t) ** 2) + 0.01 * rng.randn(len(t))
    wavfile.write(path, 16000, (x * 32767).astype(np.int16))
    pipe = setup["pipe"]
    pipe.setup_dataset(pipe.cfg, "demo", demo_input=path)
    jb = next(iter(pipe.test_dataloader))
    port = collate([GestureDataset("unused", "oliver", sdt_bp(), split="demo",
                                   demo_input=path)[0]])
    np.testing.assert_array_equal(port["audio"].numpy(), np.asarray(jb["audio"]))
    return port, jb


@pytest.mark.parametrize("bucket_s", [2.0, 0.0], ids=["bucketed", "exact"])
@pytest.mark.parametrize("seconds, frames", [(5.1, 76), (6.9, 103)])
def test_dense_demo_fp32_matches_jax(setup, seconds, frames, bucket_s):
    """``demo_step``'s dense demo at the clip's own length against JAX's
    ``_dense_demo_forward``, which pads 76 frames to a 90-frame bucket and
    103 to 120 and trims, or runs at the clip's own length."""
    pb, jb = _batches(setup, seconds)
    _jax_bucket(setup["pipe"], bucket_s)
    want = setup["pipe"]._dense_demo_forward(jb, frames, None)
    state = _port_state(setup, "fp32", "DEMO.LENGTH_BUCKET_S", str(bucket_s))
    got = V.demo_step(state, pb)
    p, w = got["poses_pred_batch"].numpy(), np.asarray(want["poses_pred_batch"])
    assert p.shape == w.shape == (1, frames, 2, 121)
    np.testing.assert_allclose(p, w, rtol=0, atol=PX_ATOL)
    np.testing.assert_array_equal(got["condition_code"].numpy(),
                                  np.asarray(want["condition_code"]))


def test_bucketed_and_exact_dense_demo_agree(setup):
    """In the port alone: DEMO.LENGTH_BUCKET_S is read and ignored, so 2.0
    and 0 give the same poses, bit for bit."""
    pb, _ = _batches(setup, 6.9)
    out = {}
    for b in (2.0, 0.0):
        state = _port_state(setup, "fp32", "DEMO.LENGTH_BUCKET_S", str(b))
        out[b] = V.demo_step(state, pb)["poses_pred_batch"].numpy()
    assert out[2.0].shape == (1, 103, 2, 121)
    np.testing.assert_array_equal(out[2.0], out[0.0])


@pytest.mark.parametrize("bucket_s", [2.0, 0.0], ids=["bucketed", "exact"])
def test_dense_demo_bf16_tracks_jax_bf16(setup, bucket_s):
    """The port's bf16 generator forward at the clip's own length against
    JAX's bf16 one, bucketed (the padded clip's mel, its valid lengths,
    trimmed) or not, normalized poses, by the bf16 quantile gate of
    ``test_generator_bf16_tracks_jax_bf16``; the port's bf16 against its
    fp32 by relative L2."""
    from speechdrivestemplates_tpu.models.generator import SequenceGeneratorCNN as JGen
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram_plain

    pb, jb = _batches(setup, 5.1)
    frames = 76
    _jax_bucket(setup["pipe"], bucket_s)
    jb, padded, valid = setup["pipe"]._bucket_demo_batch(jb, frames)
    tv, fv = (None, None) if valid is None else (jnp.int32(valid[0]), jnp.int32(valid[1]))
    jmel = mel_spectrogram_plain(torch.from_numpy(np.asarray(jb["audio"]))).numpy()
    params = setup["pipe"].state["params_g"]
    code = np.array(setup["pipe"].state["clips_code"])[1:2]
    gen = JGen(num_landmarks=121, code_dim=32, norm="IN", leaky=True, dtype=jnp.bfloat16)
    fn = jax.jit(lambda p, m, c: gen.apply({"params": p}, m, padded, c, False,
                                           t_mel_valid=tv, num_frames_valid=fv))
    ref = np.asarray(fn(params, jnp.asarray(jmel), jnp.asarray(code)),
                     np.float32)[:, :frames]
    mel = mel_spectrogram_plain(pb["audio"])
    outs = {}
    for precision in ("bf16", "fp32"):
        state = _port_state(setup, precision)
        with torch.no_grad():
            outs[precision] = state.generator.eval()(
                mel, frames, torch.from_numpy(code)).float().numpy()
    assert outs["bf16"].shape == ref.shape == (1, frames, 2, 121)
    err = np.abs(outs["bf16"] - ref)
    assert np.quantile(err, 0.99) < 0.05 and err.mean() < 0.02, (np.quantile(err, 0.99),
                                                                 err.mean())
    rel_l2 = np.linalg.norm(outs["bf16"] - outs["fp32"]) / np.linalg.norm(outs["fp32"])
    assert rel_l2 < 0.05, rel_l2


def test_windowed_demo_matches_jax(setup):
    """A 10 s clip (150 frames): four 64-frame windows at starts 0, 32, 64 and
    86, one batch, crossfaded, against JAX's ``_windowed_demo_forward``."""
    from speechdrivestemplates_tpu.ops.longform import plan_windows

    pb, jb = _batches(setup, 10.0, seed=3)
    frames = int(pb["num_frames"][0])
    assert frames == 150 and [s for s, _ in plan_windows(frames)] == [0, 32, 64, 86]
    want = setup["pipe"]._windowed_demo_forward(jb, frames, None)
    state = _port_state(setup, "fp32", "DEMO.WINDOWED", "True")
    got = V.demo_step(state, pb)
    p, w = got["poses_pred_batch"].numpy(), np.asarray(want["poses_pred_batch"])
    assert p.shape == w.shape == (1, frames, 2, 121)
    np.testing.assert_allclose(p, w, rtol=0, atol=PX_ATOL)
    np.testing.assert_array_equal(got["condition_code"].numpy(),
                                  np.asarray(want["condition_code"]))
