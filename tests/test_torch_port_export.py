"""The serving export (``utils/export.py``) on the CPU: an SDT-BP artifact from
a ``.pth`` of one seeded JAX init (carried over by ``params_from_jax``) against
the port's ``build_serving_fn`` and JAX's, its sidecar against JAX's, and the
code-less s2g export.

The export's shapes are static and any (B, L) serves: L = 16000 (1 s, the
generator still resamples to 64 frames) keeps the CPU trace and JAX's compile
short.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu.models.generator import SequenceGeneratorCNN as JGen
from speechdrivestemplates_tpu_torch.config import s2g, sdt_bp
from speechdrivestemplates_tpu_torch.models import build_model
from speechdrivestemplates_tpu_torch.serving import build_serving_fn
from speechdrivestemplates_tpu_torch.utils.export import (export_serving_fn, graph_ops,
                                                          load_serving_fn)
from speechdrivestemplates_tpu_torch.utils.weights import load_reference_pth, params_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
L = 16000
PX_ATOL = 0.01  # px: the bound of tests/test_torch_port_demo_forward.py


def save_pth(path, state_dict):
    torch.save({"epoch": 0, "step": 0,
                "model_state_dict": {"module.netG." + k: v for k, v in state_dict.items()}},
               path)
    return str(path)


@pytest.fixture(scope="module")
def bp(tmp_path_factory):
    """SDT-BP, fp32: a JAX init's weights in a reference-layout .pth, exported
    on the CPU at B = 2."""
    tmp = tmp_path_factory.mktemp("export")
    gen = JGen(num_landmarks=121, code_dim=32, norm="IN", leaky=True, dtype=None)
    variables = jax.jit(gen.init, static_argnums=(2, 4))(
        jax.random.PRNGKey(3), jnp.zeros((1, 80, 64)), 32, jnp.zeros((1, 32)), False)
    params = jax.tree.map(np.asarray, variables["params"])
    ckpt = save_pth(tmp / "bp.pth", params_from_jax(params))
    art = str(tmp / "bp_fp32_b2.pt2")
    meta = export_serving_fn(sdt_bp(precision="fp32"), ckpt, art, batch_size=2,
                             audio_length=L, device="cpu")
    return dict(params=params, ckpt=ckpt, art=art, meta=meta)


def _inputs(seed, B=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L) * 0.1).astype(np.float32), rng.randn(B, 32).astype(np.float32)


def test_cpu_artifact_equals_build_serving_fn_bit_for_bit(bp):
    art = load_serving_fn(bp["art"])
    fn, has_code = build_serving_fn(sdt_bp(precision="fp32"), load_reference_pth(bp["ckpt"]),
                                    "cpu")
    audio, code = _inputs(0)
    got = art(audio, code)
    assert has_code and got.shape == (2, 64, 2, 121) and got.dtype == torch.float32
    assert torch.equal(got, fn(audio, code))
    # the CPU export holds the plain route: no kernel op in its graph
    assert bp["meta"]["ops"] == {} and bp["meta"]["device"] == "cpu"
    program = torch.export.load(bp["art"])
    assert graph_ops(program) == {}
    # the trace's runtime metadata checks were dropped before the save
    assert not [n for n in program.graph.nodes if "_assert_tensor_metadata" in str(n.target)]
    with pytest.raises(ValueError, match="takes a template code"):
        art(audio)


def test_cpu_artifact_matches_jax_serving_fn(bp):
    from speechdrivestemplates_tpu.config import get_cfg_defaults
    from speechdrivestemplates_tpu.utils.export import build_serving_fn as jax_serving_fn

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "voice2pose_sdt_bp.yaml"))
    cfg.DATASET.SPEAKER = "oliver"
    cfg.freeze()
    jfn, _ = jax_serving_fn(cfg, bp["params"], {})
    audio, code = _inputs(1)
    ref = np.asarray(jax.jit(jfn)(jnp.asarray(audio), jnp.asarray(code)))
    got = load_serving_fn(bp["art"], "cpu")(audio, code).numpy()
    assert got.shape == ref.shape == (2, 64, 2, 121)
    np.testing.assert_allclose(got, ref, rtol=0, atol=PX_ATOL)


def _jax_sidecar_keys():
    """The keys of the sidecar that JAX's ``export_serving_fn`` writes, read
    from its source (running it would lower the graph for two platforms)."""
    path = os.path.join(ROOT, "speechdrivestemplates_tpu", "utils", "export.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "meta"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no meta dict in the JAX export")


def test_sidecar_keys_are_jax_keys_less_platforms_plus_device_torch_and_ops(bp):
    jax_keys = _jax_sidecar_keys()
    assert {"platforms", "jax_version", "bytes", "code_dim"} <= jax_keys
    assert set(bp["meta"]) == (jax_keys - {"platforms", "jax_version"}
                               | {"device", "torch_version", "ops"})
    meta = bp["meta"]
    assert (meta["batch_size"], meta["audio_length"], meta["code_dim"]) == (2, L, 32)
    assert meta["bytes"] == os.path.getsize(bp["art"]) > 7_075_122 * 4
    assert meta["inputs"] == ["audio f32[B,L]", "code f32[B,D]"]
    # the example inputs are not saved: an artifact's size does not grow with B x L
    assert torch.export.load(bp["art"]).example_inputs is None


def test_s2g_exports_with_one_input(tmp_path):
    cfg = s2g(precision="fp32")
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu",
                     generator=torch.Generator().manual_seed(5)).state_dict()
    ckpt = save_pth(tmp_path / "s2g.pth", sd)
    art = str(tmp_path / "s2g.pt2")
    meta = export_serving_fn(cfg, ckpt, art, audio_length=L, device="cpu")
    assert meta["code_dim"] is None and meta["inputs"] == ["audio f32[B,L]"]
    program = torch.export.load(art)
    assert len(program.graph_signature.user_inputs) == 1
    audio = _inputs(2, B=1)[0]
    fn, has_code = build_serving_fn(cfg, sd, "cpu")
    got = load_serving_fn(art)(audio, np.ones((1, 32), np.float32))  # a code is ignored
    assert not has_code and torch.equal(got, fn(audio))
