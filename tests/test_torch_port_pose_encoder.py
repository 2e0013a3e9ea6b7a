"""The port's BatchNorm ConvNormRelu and PoseSeqEncoder against the JAX
package's, on the CPU, with weights and statistics carried over by
``utils.weights``. Also the IN statistics' dtype: float64 stays float64, fp32
and bf16 results are those of a float32 computation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.models import PoseSeqEncoder
from speechdrivestemplates_tpu_torch.models.blocks import (NORM_EPS, ConvNormRelu,
                                                          channel_norm_1d,
                                                          instance_norm_2d)
from speechdrivestemplates_tpu_torch.utils.weights import pose_encoder_params_from_jax


def _perturbed_norms(params, rng):
    """Random BN scale and bias, so the affine part is held too."""
    def visit(node):
        if isinstance(node, dict):
            if "scale" in node:
                node["scale"] = (1.0 + 0.3 * rng.randn(*node["scale"].shape)).astype(np.float32)
                node["bias"] = (0.3 * rng.randn(*node["bias"].shape)).astype(np.float32)
            for v in node.values():
                visit(v)
    params = jax.tree.map(np.asarray, params)
    visit(params)
    return params


def _stats(stats):
    return jax.tree.map(np.array, stats)  # writable host copies


def _assert_rel_l2(got, want, bound, what):
    """Running statistics are held per tensor: a channel mean near zero has
    the absolute error of fp32 sums over O(1) values, so its own relative
    error says nothing."""
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= bound, (what, rel)


@pytest.mark.parametrize("downsample", [False, True])
def test_bn_conv_norm_relu_matches_jax(rng, downsample):
    """Train mode (batch statistics, two running-stat updates) and eval mode
    (running statistics) against the JAX TorchBatchNorm, fp32."""
    from speechdrivestemplates_tpu.models.blocks import ConvNormRelu as JCNR

    x1 = (rng.randn(4, 16, 12) + 0.5).astype(np.float32)  # JAX layout (B, T, C)
    x2 = (rng.randn(4, 16, 12) * 2.0 - 0.3).astype(np.float32)
    jm = JCNR(conv_type="1d", out_channels=24, downsample=downsample, norm="BN",
              leaky=True)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x1), False)
    params = _perturbed_norms(variables["params"], rng)
    stats = _stats(variables["batch_stats"])
    tm = ConvNormRelu("1d", 12, 24, downsample=downsample, norm="BN", leaky=True)
    tm.load_state_dict({"conv.weight": torch.from_numpy(
                            np.ascontiguousarray(params["conv"]["kernel"].transpose(2, 1, 0))),
                        "norm.weight": torch.from_numpy(params["norm"]["scale"]),
                        "norm.bias": torch.from_numpy(params["norm"]["bias"]),
                        "norm.running_mean": torch.from_numpy(stats["norm"]["mean"]),
                        "norm.running_var": torch.from_numpy(stats["norm"]["var"]),
                        "norm.num_batches_tracked": torch.tensor(0)}, strict=True)

    def to_port(a):
        return torch.from_numpy(a).transpose(1, 2)

    tm.train()
    for x in (x1, x2):
        ref, upd = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            True, mutable=["batch_stats"])
        stats = _stats(upd["batch_stats"])
        with torch.no_grad():
            got = tm(to_port(x)).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    _assert_rel_l2(tm.norm.running_mean.numpy(), stats["norm"]["mean"], 1e-6, "mean")
    _assert_rel_l2(tm.norm.running_var.numpy(), stats["norm"]["var"], 1e-6, "var")
    assert int(tm.norm.num_batches_tracked) == 2

    tm.eval()
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x1), False)
    with torch.no_grad():
        got = tm(to_port(x1)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bn_running_var_takes_the_unbiased_variance():
    """torch's rule: the EMA takes var * n / (n - 1), the output the biased var."""
    from speechdrivestemplates_tpu_torch.models.blocks import BN_MOMENTUM, BatchNorm

    x = torch.tensor([[[1.0, 2.0, 4.0]], [[0.0, 3.0, 2.0]]])  # (B=2, C=1, T=3)
    bn = BatchNorm(1).train()
    y = bn(x)
    n, var_b = 6, x.var(correction=0)
    torch.testing.assert_close(bn.running_var, (1 - BN_MOMENTUM) + BN_MOMENTUM * var_b * n / (n - 1)
                               * torch.ones(1))
    torch.testing.assert_close(y, (x - x.mean()) / torch.sqrt(var_b + NORM_EPS))
    ref = torch.nn.BatchNorm1d(1).train()
    with torch.no_grad():
        ref(x)
    torch.testing.assert_close(bn.running_var, ref.running_var)
    torch.testing.assert_close(bn.running_mean, ref.running_mean)


@pytest.fixture(scope="module")
def encoder_pair():
    """A JAX PoseSeqEncoder (BN, leaky, code 32) with random BN affines, and
    the port's with the same weights and statistics."""
    from speechdrivestemplates_tpu.models.autoencoder import PoseSeqEncoder as JEnc

    rng = np.random.RandomState(1)
    jm = JEnc(num_landmarks=121, code_dim=32, norm="BN", leaky=True)
    variables = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 2, 121)), True)
    params = _perturbed_norms(variables["params"], rng)
    stats = _stats(variables["batch_stats"])
    tm = PoseSeqEncoder(num_landmarks=121, code_dim=32, norm="BN", leaky=True)
    tm.load_state_dict(pose_encoder_params_from_jax(params, stats), strict=True)
    return jm, params, stats, tm


def _port_stats(tm):
    return [(b.norm.running_mean.numpy().copy(), b.norm.running_var.numpy().copy())
            for b in tm.blocks]


def test_pose_encoder_names_are_the_reference_blocks(encoder_pair):
    _, _, _, tm = encoder_pair
    names = set(tm.state_dict())
    assert {n.split(".")[1] for n in names} == {str(i) for i in range(7)}
    assert "blocks.6.norm.running_var" in names and "blocks.0.conv.weight" in names
    assert tuple(tm.blocks[0].conv.weight.shape) == (256, 242, 3)
    assert tuple(tm.blocks[6].conv.weight.shape) == (64, 256, 4)


@pytest.mark.parametrize("train", [False, True])
def test_pose_encoder_matches_jax(rng, encoder_pair, train):
    """mu and logvar of (4, 64, 2, 121) poses, in eval and in train mode."""
    jm, params, stats, tm = encoder_pair
    poses = rng.randn(4, 64, 2, 121).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if train:
        (mu, lv), _ = jm.apply(variables, jnp.asarray(poses), True, mutable=["batch_stats"])
    else:
        mu, lv = jm.apply(variables, jnp.asarray(poses), False)
    enc = PoseSeqEncoder(num_landmarks=121, code_dim=32)
    enc.load_state_dict(tm.state_dict())
    enc.train(train)
    with torch.no_grad():
        tmu, tlv = enc(torch.from_numpy(poses))
    assert tmu.shape == tlv.shape == (4, 32)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(lv), rtol=1e-4, atol=1e-5)


def test_pose_encoder_statistics_after_pred_then_gt_match_jax(rng, encoder_pair):
    """The train step's cadence: a train-mode forward on the prediction, then
    one on the ground truth, each moving every block's running statistics."""
    jm, params, stats, tm = encoder_pair
    pred = (rng.randn(4, 64, 2, 121) * 0.8).astype(np.float32)
    gt = (rng.randn(4, 64, 2, 121) + 0.2).astype(np.float32)
    bs = stats
    for x in (pred, gt):
        _, upd = jm.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), True,
                          mutable=["batch_stats"])
        bs = _stats(upd["batch_stats"])
    enc = PoseSeqEncoder(num_landmarks=121, code_dim=32)
    enc.load_state_dict(tm.state_dict())
    enc.train()
    with torch.no_grad():
        for x in (pred, gt):
            enc(torch.from_numpy(x))
    for i, (m, v) in enumerate(_port_stats(enc)):
        ref = bs[f"ConvNormRelu_{i}"]["norm"]
        _assert_rel_l2(m, ref["mean"], 1e-5, f"blocks.{i} running_mean")
        _assert_rel_l2(v, ref["var"], 1e-5, f"blocks.{i} running_var")


def test_norm_statistics_keep_float64(rng):
    """float64 inputs normalize in float64 (the gradient test needs it); fp32
    and bf16 inputs give bit for bit what a float32 computation gives."""
    def old_2d(x):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(-2, -1), correction=0, keepdim=True)
        return (xf - mean) * torch.rsqrt(var + NORM_EPS)

    def old_1d(x):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
        return (xf - mean) * torch.rsqrt(var + NORM_EPS)

    x2 = torch.from_numpy(rng.randn(2, 3, 5, 7) * 3 + 1)
    x1 = torch.from_numpy(rng.randn(2, 6, 9) * 3 + 1)
    for x, new, old in ((x2, instance_norm_2d, old_2d), (x1, channel_norm_1d, old_1d)):
        assert new(x).dtype == torch.float64
        for dtype in (torch.float32, torch.bfloat16):
            got = new(x.to(dtype))
            assert got.dtype == torch.float32
            assert torch.equal(got, old(x.to(dtype)))
        # float64 statistics: the result is the float64 normalization
        ref = (x - x.mean(dim=(-2, -1) if x.ndim == 4 else 1, keepdim=True))
        assert torch.allclose(new(x) * torch.sqrt(
            x.var(dim=(-2, -1) if x.ndim == 4 else 1, correction=0, keepdim=True) + NORM_EPS),
            ref, rtol=1e-12, atol=1e-12)
