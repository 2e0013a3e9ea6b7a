"""The port's fused conv1 + IN1 (the plain path of its CUDA kernel) against the
JAX package's Pallas kernel (probes/conv1_pallas.py), run in interpret mode on
the CPU.

Same inputs as tests/test_conv1_pallas.py; the port takes the OIHW weight and
returns the same (B, 82, W1, 64) h-padded layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probes import conv1_pallas as CP
from speechdrivestemplates_tpu.models.blocks import NORM_EPS
from speechdrivestemplates_tpu_torch.ops import conv1 as tconv1
from speechdrivestemplates_tpu_torch.ops import stem as tstem


def make_inputs(rng, batch, width):
    mel = rng.randn(batch, CP.H1, width).astype(np.float32)
    w1 = (rng.randn(3, 3, 1, 64) * 0.2).astype(np.float32)  # HWIO, as the JAX kernel takes
    return mel, w1


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def port_conv1(mel, w1, slope=0.2, dtype=torch.float32):
    return tconv1.fused_conv1_in(torch.from_numpy(mel), oihw(w1), slope, dtype)


def jax_conv1(mel, w1, slope=0.2, dtype=jnp.float32):
    return np.asarray(CP.fused_conv1_in(jnp.asarray(mel), jnp.asarray(w1), slope=slope,
                                        dtype=dtype, interpret=True), np.float32)


def ref_layer(x, w, stride, slope=0.2):
    """tests/test_conv1_pallas.py's reference ConvNormRelu (NHWC, HWIO)."""
    x = jax.lax.conv_general_dilated(
        x, w, window_strides=stride, padding=[(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    m = jnp.mean(x, axis=(1, 2), keepdims=True)
    v = jnp.var(x, axis=(1, 2), keepdims=True)
    x = (x - m) * jax.lax.rsqrt(v + NORM_EPS)
    return jnp.where(x > 0, x, slope * x)


@pytest.mark.parametrize("width", [427, 37])
def test_port_conv1_fp32_matches_jax_kernel(width):
    mel, w1 = make_inputs(np.random.RandomState(0), 2, width)
    got = port_conv1(mel, w1)
    assert got.dtype == torch.float32 and got.shape == (2, tconv1.ROWS, width, 64)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 0], 0.0)
    np.testing.assert_array_equal(got[:, -1], 0.0)
    np.testing.assert_allclose(got, jax_conv1(mel, w1), rtol=2e-5, atol=2e-5)


def test_port_conv1_bf16_close_to_fp32():
    """bf16 is a cast of the fp32 result: the gate of tests/test_conv1_pallas.py."""
    mel, w1 = make_inputs(np.random.RandomState(1), 1, 160)
    got = port_conv1(mel, w1, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = jax_conv1(mel, w1)
    err = np.abs(got - ref).mean() / (np.abs(ref).mean() + 1e-8)
    assert err < 2e-2, err
    np.testing.assert_array_equal(got[:, [0, -1]], 0.0)


def test_port_conv1_relu_variant():
    mel, w1 = make_inputs(np.random.RandomState(3), 2, 64)
    got = port_conv1(mel, w1, slope=0.0).numpy()
    assert got.min() >= 0.0
    np.testing.assert_allclose(got, jax_conv1(mel, w1, slope=0.0), rtol=2e-5, atol=2e-5)


def test_port_conv1_layer1_composition():
    """The port's padded output through conv2 with padding (0, 1) equals the
    reference layer0(p=1) -> layer1(k4 s2 p=1) chain."""
    rng = np.random.RandomState(2)
    mel, w1 = make_inputs(rng, 2, 67)
    w2 = (rng.randn(4, 4, 64, 64) * 0.05).astype(np.float32)
    ref = np.asarray(ref_layer(ref_layer(mel[..., None], w1, (1, 1)), w2, (2, 2)))

    pad = port_conv1(mel, w1).permute(0, 3, 1, 2)
    x = F.conv2d(pad, oihw(w2), stride=2, padding=(0, 1))
    var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    x = F.leaky_relu((x - mean) * torch.rsqrt(var + NORM_EPS), 0.2)
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_tail_on_conv1_equals_plain_stem(dtype):
    """The kernel route's split, conv1 then the stem's tail on the padded
    activation, computes the plain stem (fp32: to round-off; bf16: only
    conv1's arithmetic differs, fp32 in the split)."""
    rng = np.random.RandomState(4)
    mel = torch.from_numpy(rng.randn(2, 80, 45).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(64, 1, 3, 3) * 0.2).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(64, 64, 4, 4) * 0.05).astype(np.float32))
    w3 = torch.from_numpy((rng.randn(128, 64, 3, 3) * 0.05).astype(np.float32))
    y1 = tconv1.fused_conv1_in(mel, w1, 0.2, dtype)
    got = tstem.stem_tail_plain(y1, w2, w3, 0.2, dtype).float()
    ref = tstem.stem_plain(mel, w1, w2, w3, 0.2, dtype).float()
    assert got.shape == ref.shape == (2, 40, tstem.stem_dims(45)[1], 128)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)
    else:
        err = (got - ref).abs()
        assert torch.quantile(err.flatten(), 0.99) < 0.05 and err.mean() < 0.02


def test_conv1_kernel_wrapper_rejects_cpu_tensors():
    """The kernel entry never runs on the CPU: the dispatcher picks the plain
    version there, and the kernel wrapper itself raises."""
    from speechdrivestemplates_tpu_torch import kernels

    mel, w1 = make_inputs(np.random.RandomState(5), 1, 16)
    before = sum(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        tconv1.conv1_in_kernel(torch.from_numpy(mel), oihw(w1))
    with pytest.raises(ValueError, match="CUDA"):
        tstem.stem_tail_kernel(torch.zeros(1, 82, 16, 64), torch.zeros(64, 64, 4, 4),
                               torch.zeros(128, 64, 3, 3))
    assert sum(kernels.LAUNCHES.values()) == before
