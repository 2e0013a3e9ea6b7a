"""The sequence-parallel generator (``parallel/seqparallel.py``) against the
JAX package's ``parallel/seqparallel.py``, and the demo route that takes it.

The same seeded JAX weights (IN generators with and without a clip code,
and a BN one, whose running statistics are drawn at random, as JAX's own
test draws them) go through JAX's ``generator_seq_parallel`` on a 2- and a 4-device mesh
of ``tests/conftest.py``'s CPU devices, through the port's on 2 and 4 gloo
ranks (``parallel.dist.spawn``), and through the port's dense eval forward.
The gate is JAX's own (``tests/test_multiprocess.py``): the largest absolute
difference over the largest absolute value of the reference, below 1e-4.
"""

import logging

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.parallel import dist as pdist

# SDT-BP's generator (IN, a code), an IN one without a code, s2g's (BN, no code)
CASES = [("IN", True), ("IN", False), ("BN", False)]
T_FRAMES, T_MEL = 128, 512  # T_MEL % (8 * 4) == 0 and T_FRAMES % (32 * 4) == 0
REL = 1e-4
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def rank_threads():
    """Two intra-op threads a spawned rank (they inherit the variable) and in
    this process while the module runs: the test session runs several
    workers on the host's cores already."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setenv("OMP_NUM_THREADS", "2")
            yield
    finally:
        torch.set_num_threads(threads)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-8))


def _port_generator(norm: str, with_code: bool, state_dict=None):
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model

    cfg = sdt_bp(precision="fp32")
    cfg.VOICE2POSE.GENERATOR.NORM = norm
    cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION = 32 if with_code else None
    gen = build_model("SequenceGeneratorCNN", cfg, "cpu")
    if state_dict is not None:
        gen.load_state_dict(state_dict, strict=True)
    return gen


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    """Per case: the JAX weights as the port's state_dict, the mel, the code,
    and JAX's sequence-parallel output on the 2- and 4-device meshes."""
    import jax
    import jax.numpy as jnp

    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.models import build_model
    from speechdrivestemplates_tpu.parallel import mesh as mesh_lib
    from speechdrivestemplates_tpu.parallel.seqparallel import generator_seq_parallel
    from speechdrivestemplates_tpu_torch.utils.weights import params_from_jax

    rng = np.random.RandomState(0)
    mel = (rng.randn(1, 80, T_MEL) * 2).astype(np.float32)
    code = rng.randn(1, 32).astype(np.float32)
    cases = {}
    for norm, with_code in CASES:
        cfg = get_cfg_defaults()
        cfg.VOICE2POSE.GENERATOR.NORM = norm
        cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION = 32 if with_code else None
        cfg.freeze()
        gen = build_model("SequenceGeneratorCNN", cfg)
        c = jnp.asarray(code) if with_code else None
        variables = jax.jit(gen.init, static_argnums=(2, 4))(
            jax.random.PRNGKey(len(cases)), jnp.asarray(mel), T_FRAMES, c, False)
        stats = None
        if norm == "BN":
            stats = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
                                 variables["batch_stats"])
        out = {}
        for n in (2, 4):
            out[n] = np.asarray(generator_seq_parallel(
                mesh_lib.get_data_mesh(n), variables["params"], mel, T_FRAMES,
                code if with_code else None, leaky=True, norm=norm, batch_stats=stats))
        cases[(norm, with_code)] = {
            "state_dict": params_from_jax(jax.device_get(variables["params"]),
                                          None if stats is None else jax.device_get(stats)),
            "jax": out}
    path = str(tmp_path_factory.mktemp("seqpar") / "cases.pt")
    torch.save({k: v["state_dict"] for k, v in cases.items()}, path)
    return {"cases": cases, "mel": mel, "code": code, "path": path}


def _seq_worker(rank, device, path, mel, code):
    """Each case's sequence-parallel forward on this rank, and on rank 0 the
    dense one."""
    from speechdrivestemplates_tpu_torch.parallel.seqparallel import generator_seq_parallel

    weights = torch.load(path, weights_only=False)
    mel_t = torch.from_numpy(mel)
    out = {}
    for (norm, with_code), sd in weights.items():
        gen = _port_generator(norm, with_code, sd)
        c = torch.from_numpy(code) if with_code else None
        dense = None
        if rank == 0:
            with torch.no_grad():
                dense = gen(mel_t, T_FRAMES, c)
        out[(norm, with_code)] = (generator_seq_parallel(gen, mel_t, T_FRAMES, c), dense)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def port_ranks(request, jax_cases):
    n = request.param
    return n, pdist.spawn(_seq_worker, n, (jax_cases["path"], jax_cases["mel"],
                                           jax_cases["code"]), device="cpu",
                          timeout_s=RANK_TIMEOUT_S)


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{'code' if c else 'nocode'}"
                                             for n, c in CASES])
def test_ranks_match_jax_mesh_and_dense(port_ranks, jax_cases, case):
    """n gloo ranks = JAX on an n-device mesh = the port's dense forward
    (rel < 1e-4), and every rank holds the same frames, bit for bit."""
    n, ranks = port_ranks
    seq0, dense = ranks[0][case]
    assert seq0.shape == dense.shape == (1, T_FRAMES, 2, 121)
    for r in ranks[1:]:
        assert torch.equal(r[case][0], seq0)
    rel_jax = _rel(seq0, jax_cases["cases"][case]["jax"][n])
    rel_dense = _rel(seq0, dense)
    assert rel_jax < REL and rel_dense < REL, (rel_jax, rel_dense)


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-{'code' if c else 'nocode'}"
                                             for n, c in CASES])
def test_one_rank_in_process_is_the_dense_forward(jax_cases, case):
    """Without a process group the route is one slice with zero halos: the
    dense forward, to rounding."""
    from speechdrivestemplates_tpu_torch.parallel.seqparallel import generator_seq_parallel

    norm, with_code = case
    gen = _port_generator(norm, with_code, jax_cases["cases"][case]["state_dict"])
    mel = torch.from_numpy(jax_cases["mel"])
    code = torch.from_numpy(jax_cases["code"]) if with_code else None
    with torch.no_grad():
        dense = gen(mel, T_FRAMES, code)
    assert _rel(generator_seq_parallel(gen, mel, T_FRAMES, code), dense) < REL


@pytest.mark.parametrize("in_len,out_len,n,valid", [
    (64, 128, 8, None), (400, 512, 8, 398), (96, 48, 8, None), (80, 80, 8, None),
    (128, 128, 2, 126), (128, 128, 4, 126), (4, 8, 4, None)])
def test_banded_resize_matrices_are_jaxs(in_len, out_len, n, valid):
    from speechdrivestemplates_tpu.parallel.seqparallel import make_sharded_resize as jax_msr
    from speechdrivestemplates_tpu_torch.parallel.seqparallel import make_sharded_resize

    mats, halo = make_sharded_resize(in_len, out_len, n, valid_src=valid)
    jmats, jhalo = jax_msr(in_len, out_len, n, valid_src=valid)
    assert halo == jhalo
    np.testing.assert_array_equal(mats, np.asarray(jmats))


def test_errors_are_jaxs():
    """A clip too short for the ranks and an unknown norm raise as JAX's do."""
    from speechdrivestemplates_tpu.parallel import mesh as mesh_lib
    from speechdrivestemplates_tpu.parallel.seqparallel import generator_seq_parallel as jax_gsp
    from speechdrivestemplates_tpu.parallel.seqparallel import make_sharded_resize as jax_msr
    from speechdrivestemplates_tpu_torch.parallel.seqparallel import (generator_seq_parallel,
                                                                      make_sharded_resize)

    for fn in (make_sharded_resize, jax_msr):
        with pytest.raises(ValueError, match="too short"):
            fn(16, 256, 8, valid_src=2)
        with pytest.raises(ValueError, match="no valid source columns"):
            fn(16, 256, 8, valid_src=0)
    with pytest.raises(ValueError, match="unknown norm 'bn'"):
        jax_gsp(mesh_lib.get_data_mesh(8), {}, np.zeros((1, 80, 64 * 8), np.float32), 32 * 8,
                None, norm="bn")
    gen = _port_generator("IN", False)
    with pytest.raises(ValueError, match="unknown norm 'bn'"):
        generator_seq_parallel(gen, torch.zeros(1, 80, 64), 32, norm="bn")
    with pytest.raises(ValueError, match="norm 'BN'"):
        generator_seq_parallel(gen, torch.zeros(1, 80, 64), 32, norm="BN")
    with pytest.raises(ValueError, match="pass `code` iff"):
        generator_seq_parallel(gen, torch.zeros(1, 80, 256), 32, torch.zeros(1, 32))


# ---- the demo route -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_setup(tmp_path_factory):
    from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import GestureDataset, collate
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState
    from scipy.io import wavfile

    tmp = tmp_path_factory.mktemp("seqdemo")
    t = np.arange(int(5.3 * 16000)) / 16000
    wav = str(tmp / "clip.wav")
    wavfile.write(wav, 16000, (0.1 * np.sin(2 * np.pi * 150 * t)
                               + 0.02 * np.random.RandomState(0).randn(len(t))).astype(np.float32))
    cfg = apply_overrides(sdt_bp(precision="fp32"), ["DEMO.SEQUENCE_PARALLEL", "True",
                                                     "DEMO.CODE_INDEX", "1"])
    state = Voice2PoseTrainState(cfg, 4, "cpu")
    with torch.no_grad():
        state.clips_code.copy_(torch.from_numpy(
            np.random.RandomState(2).randn(4, 32).astype(np.float32)))
    batch = collate([GestureDataset("unused", "oliver", cfg, split="demo", demo_input=wav)[0]])
    return state, batch


def test_demo_route_is_the_dense_forward_on_the_padded_clip(demo_setup):
    """DEMO.SEQUENCE_PARALLEL (one rank, in process): the clip's audio padded
    to 8 x ranks mel columns, the forward at its frames padded to 32 x ranks,
    the pad frames trimmed (the JAX ``_seq_parallel_demo_forward``) = the
    dense eval forward on the same padded audio, trimmed."""
    from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram
    from speechdrivestemplates_tpu_torch.ops.pose import get_final_results
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import demo_step

    state, batch = demo_setup
    frames = int(batch["num_frames"][0])
    assert frames % 32
    got = demo_step(state, batch)
    assert got["poses_pred_batch"].shape == (1, frames, 2, 121)
    audio = batch["audio"][0].numpy()
    t_mel = -(-(len(audio) // 160 + 2) // 8) * 8
    pad = np.zeros(((t_mel - 1) * 160,), np.float32)
    pad[:len(audio)] = audio
    code = state.clips_code[1][None].detach()
    with torch.no_grad():
        state.generator.eval()
        pred = state.generator(mel_spectrogram(torch.from_numpy(pad[None])),
                               -(-frames // 32) * 32, code)[:, :frames]
    stat = batch["speaker_stat"]
    ref = get_final_results(pred, stat["mean"], stat["std"], stat["scale_factor"], True, 121)
    assert _rel(got["poses_pred_batch"], ref) < REL
    assert torch.equal(got["condition_code"], code)


def test_demo_takes_the_dense_forward_where_the_clip_is_too_short(demo_setup, monkeypatch,
                                                                  caplog):
    """The JAX ``demo_step``: the sharded route's ValueError (a clip too short
    for the ranks' halos) logs a warning and runs the dense forward."""
    from speechdrivestemplates_tpu_torch.pipelines import voice2pose

    state, batch = demo_setup

    def too_short(*a, **k):
        raise ValueError("forced: clip too short for these ranks")

    monkeypatch.setattr(voice2pose, "seq_parallel_demo_forward", too_short)
    with caplog.at_level(logging.WARNING):
        got = voice2pose.demo_step(state, batch)
    assert "DEMO.SEQUENCE_PARALLEL unavailable for this clip" in caplog.text
    dense = voice2pose.eval_step(state, batch, num_frames=int(batch["num_frames"][0]))[1]
    assert torch.equal(got["poses_pred_batch"], dense["poses_pred_batch"])


def test_frame_variant_codes_are_refused_as_jax_refuses_them(tmp_path):
    from speechdrivestemplates_tpu_torch.config import apply_overrides, sdt_bp
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                      demo_step)

    cfg = apply_overrides(sdt_bp(precision="fp32"), [
        "DEMO.SEQUENCE_PARALLEL", "True", "VOICE2POSE.GENERATOR.CLIP_CODE.FRAME_VARIANT", "True"])
    state = Voice2PoseTrainState(cfg, 2, "cpu")
    batch = {"audio": torch.zeros(1, 68267), "num_frames": torch.tensor([64])}
    with pytest.raises(NotImplementedError, match="does not support FRAME_VARIANT"):
        demo_step(state, batch)
