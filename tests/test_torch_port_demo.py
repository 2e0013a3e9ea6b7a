"""The demo's host side and building blocks against the JAX package, on the
CPU: the wav reader, the demo split, the long-form functions and the
streaming session (with a stub forward, so no generator runs here)."""

import os
import types

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _jax_cfg(*opts):
    from speechdrivestemplates_tpu.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(CONFIG_DIR, "voice2pose_sdt_bp.yaml"))
    cfg.merge_from_list(["DATASET.SPEAKER", "oliver", *opts])
    cfg.freeze()
    return cfg


def _write_wav(path, seconds, sr, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(int(seconds * sr)) * 0.1
    wavfile.write(path, sr, (x * 32767).astype(np.int16) if dtype == "int16"
                  else x.astype(np.float32))
    return path


# ---- the wav reader -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("sr", [16000, 22050, 44100])
def test_load_wav_matches_jax(tmp_path, sr, dtype):
    """scipy's reader and resample_poly to 16 kHz, sample for sample."""
    from speechdrivestemplates_tpu.utils.audio import load_wav as jax_load
    from speechdrivestemplates_tpu_torch.utils.audio import load_wav

    path = _write_wav(str(tmp_path / f"a_{sr}_{dtype}.wav"), 1.3, sr, dtype, seed=sr)
    got, want = load_wav(path), jax_load(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert abs(len(got) - int(1.3 * 16000)) <= 1
    np.testing.assert_array_equal(got, want)


def test_load_wav_stereo_is_averaged_to_mono_as_in_jax(tmp_path):
    from speechdrivestemplates_tpu.utils.audio import load_wav as jax_load
    from speechdrivestemplates_tpu_torch.utils.audio import load_wav

    path = str(tmp_path / "stereo.wav")
    x = (np.random.RandomState(1).randn(24000, 2) * 3000).astype(np.int16)
    wavfile.write(path, 24000, x)
    got = load_wav(path)
    assert got.shape == (16000,)
    np.testing.assert_array_equal(got, jax_load(path))


def test_load_wav_of_another_container_needs_ffmpeg(tmp_path, monkeypatch):
    from speechdrivestemplates_tpu_torch.utils import audio

    monkeypatch.setattr(audio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        audio.load_wav(str(tmp_path / "talk.m4a"))


# ---- the demo split -------------------------------------------------------------

@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Seven wavs of 2-6 s at three rates, and a file that is no wav."""
    d = tmp_path_factory.mktemp("wavs")
    for i, (sec, sr) in enumerate([(5.1, 16000), (2.0, 44100), (6.2, 22050), (3.3, 16000),
                                   (4.4, 44100), (2.7, 16000), (5.6, 22050)]):
        _write_wav(str(d / f"clip{i}.wav"), sec, sr, "int16" if i % 2 else "float32", seed=i)
    (d / "notes.txt").write_text("not audio")
    return str(d)


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(port_items, jax_items):
    assert len(port_items) == len(jax_items)
    for p, j in zip(port_items, jax_items):
        assert set(p) == set(j) - {"speaker"}  # the port's items carry no strings
        for k in ("audio", "num_frames", "clip_index"):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        assert p["audio"].dtype == j["audio"].dtype == np.float32
        for k in j["speaker_stat"]:
            np.testing.assert_array_equal(p["speaker_stat"][k], j["speaker_stat"][k])


@pytest.mark.parametrize("opts", [[], ["SYS.SEED", "5", "DATASET.MAX_DEMO_LENGTH", "3"],
                                  ["DATASET.HIERARCHICAL_POSE", "False"]],
                         ids=["default", "seed5-crop3s", "global-poses"])
def test_demo_split_of_a_directory_matches_jax(wav_dir, opts):
    """Sorted listing, shuffled by default_rng(SYS.SEED), wavs only, cut to
    DEMO.NUM_SAMPLES; each item's seeded crop, frame snap and short-clip pad."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JDS
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset

    opts = ["DEMO.NUM_SAMPLES", "5", *opts]
    jcfg = _jax_cfg(*opts)
    port = GestureDataset("unused", "oliver", apply_overrides(sdt_bp(), list(opts)),
                          split="demo", demo_input=wav_dir)
    jax_ds = JDS("unused", "oliver", "demo", jcfg, demo_input=wav_dir)
    assert port.clips == jax_ds.clips and len(port.clips) == 5
    _assert_items_equal(_items(port), _items(jax_ds))


def test_demo_split_of_a_path_list_crops_and_pads_as_jax(wav_dir):
    """A space-separated list: a clip over MAX_DEMO_LENGTH is cropped at the
    start default_rng(SEED + index) draws; one shorter than NUM_FRAMES frames
    is zero-padded to 64 frames (68,266 samples)."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import GestureDataset as JDS
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset

    paths = " ".join(os.path.join(wav_dir, f"clip{i}.wav") for i in (2, 1, 6))
    opts = ["DATASET.MAX_DEMO_LENGTH", "5"]
    port = GestureDataset("unused", "oliver", apply_overrides(sdt_bp(), list(opts)),
                          split="demo", demo_input=paths)
    items = _items(port)
    _assert_items_equal(items, _items(JDS("unused", "oliver", "demo", _jax_cfg(*opts),
                                          demo_input=paths)))
    assert [int(it["num_frames"]) for it in items] == [75, 64, 75]
    assert items[1]["audio"].shape == (68266,) and not items[1]["audio"][32000:].any()


def test_demo_loader_batches_one_clip(wav_dir):
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import (GestureDataset,
                                                                          collate)

    ds = GestureDataset("unused", "oliver", sdt_bp(), split="demo",
                        demo_input=os.path.join(wav_dir, "clip0.wav"))
    b = collate([ds[0]])
    assert b["audio"].shape == (1, 76 * 16000 // 15) and int(b["num_frames"][0]) == 76
    assert ds.materialize() is None


# ---- long-form windows and the streaming session ------------------------------------

@pytest.mark.parametrize("num_frames", [40, 64, 65, 100, 128, 150, 360])
@pytest.mark.parametrize("window, halo", [(64, 16), (64, 8), (96, 16)])
def test_longform_functions_equal_jax(rng, num_frames, window, halo):
    from speechdrivestemplates_tpu.ops import longform as J
    from speechdrivestemplates_tpu_torch.ops import longform as P

    assert P.plan_windows(num_frames, window, halo) == J.plan_windows(num_frames, window, halo)
    audio = rng.randn(int(num_frames * 16000 / 15)).astype(np.float32)
    (pw, pplan), (jw, jplan) = (m.window_audio(audio, num_frames, window, halo) for m in (P, J))
    assert pplan == jplan
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(P.crossfade_ramp(window, halo), J.crossfade_ramp(window, halo))
    poses = rng.randn(len(pplan), window, 2, 5).astype(np.float32)
    np.testing.assert_array_equal(P.stitch_windows(poses, pplan, num_frames, halo),
                                  J.stitch_windows(poses, jplan, num_frames, halo))


K_STUB = 5


def stub_forward(audio):
    """(n, 68266) -> (n, 64, 2, K): per-frame statistics of each window plus
    a running sum over it, so that a window placed wrong changes the output."""
    a = np.asarray(audio, np.float32)
    frames = a[:, : 64 * 1066].reshape(len(a), 64, 1066)
    base = np.stack([frames.mean(2), frames.std(2)], axis=2)
    glob = np.cumsum(frames.sum(2), axis=1)[:, :, None] * 1e-3
    return ((base + glob)[..., None] * (1.0 + np.arange(K_STUB))).astype(np.float32)


def _stream(session_cls, audio, chunk):
    sess = session_cls(stub_forward, 64, 16, K_STUB)
    got = [sess.feed(audio[i: i + chunk]) for i in range(0, len(audio), chunk)]
    got.append(sess.flush())
    return np.concatenate([g for g in got if g.size])


@pytest.mark.parametrize("num_frames", [40, 64, 100, 128, 151])
def test_streaming_equals_jax_session_and_the_windowed_demo(rng, monkeypatch, num_frames):
    """Fed in 0.5 s chunks, the port's session returns JAX's session's frames
    and the port's windowed demo's (``windowed_demo_forward``, its eval
    forward replaced by the stub), bit for bit."""
    from speechdrivestemplates_tpu.utils.streaming import StreamingPoseSession as JSession
    from speechdrivestemplates_tpu_torch.pipelines import voice2pose as V
    from speechdrivestemplates_tpu_torch.utils.audio import parse_audio_length
    from speechdrivestemplates_tpu_torch.utils.streaming import StreamingPoseSession

    audio = (rng.randn(int(num_frames * 16000 / 15) + 300) * 0.1).astype(np.float32)
    got = _stream(StreamingPoseSession, audio, 8000)
    np.testing.assert_array_equal(got, _stream(JSession, audio, 8000))

    def stub_eval_step(state, batch, fixed_code=None, plain=False, num_frames=None, **kw):
        assert num_frames == 64 and fixed_code is None
        return {}, {"poses_pred_batch": torch.from_numpy(stub_forward(batch["audio"]))}

    monkeypatch.setattr(V, "eval_step", stub_eval_step)
    L, frames = parse_audio_length(len(audio), 16000, 15)
    state = types.SimpleNamespace(cfg=apply_overrides(sdt_bp(), ["DEMO.WINDOWED", "True"]),
                                  clips_code=None)
    batch = {"audio": torch.from_numpy(audio[None, :L]), "num_frames": torch.tensor([frames]),
             "speaker_stat": {"mean": torch.zeros(1, 242), "scale_factor": torch.ones(1)}}
    offline = V.windowed_demo_forward(state, batch, frames)["poses_pred_batch"][0].numpy()
    assert got.shape == offline.shape == (frames, 2, K_STUB)
    np.testing.assert_array_equal(got, offline)


def test_streaming_is_chunk_size_invariant(rng):
    from speechdrivestemplates_tpu_torch.utils.streaming import StreamingPoseSession

    audio = (rng.randn(int(150 * 16000 / 15)) * 0.1).astype(np.float32)
    ref = _stream(StreamingPoseSession, audio, len(audio))
    for chunk in (777, 16000, 68266):
        np.testing.assert_array_equal(_stream(StreamingPoseSession, audio, chunk), ref)
