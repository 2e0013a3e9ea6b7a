"""The arithmetic of the port's conv1 kernel (csrc/conv1.cu) restated in torch:
statistics from the fp64 Gram matrix of the nine shifted mel views
(``conv1_stats_gram``) and the norm folded into the taps (``conv1_in_folded``),
held to ``conv1_in_plain`` and to the JAX package's Pallas kernel
(probes/conv1_pallas.py) in interpret mode on the CPU.

Three mels, made with numpy from a seed: zero-mean; power-like (nonnegative and
heavy-tailed, as the mel from the frontend is: the generator takes mel power,
not log-mel); and one with a large constant offset, where E[y^2] - E[y]^2
cancels most of its digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probes import conv1_pallas as CP
from speechdrivestemplates_tpu_torch.ops import conv1 as tconv1

KINDS = ("zero-mean", "power", "offset")
OFFSET = 100.0


def make_mel(kind, rng, batch, width):
    if kind == "zero-mean":
        mel = rng.randn(batch, 80, width)
    elif kind == "power":  # exponential bins under a heavy-tailed per-bin loudness
        mel = (rng.standard_exponential((batch, 80, width))
               * rng.standard_exponential((batch, 80, 1)) ** 2 * 3.0)
    else:
        mel = OFFSET + rng.randn(batch, 80, width)
    return mel.astype(np.float32)


def make_inputs(kind, seed, batch, width):
    rng = np.random.RandomState(seed)
    mel = make_mel(kind, rng, batch, width)
    w1 = (rng.randn(64, 1, 3, 3) * 0.2).astype(np.float32)  # OIHW
    return mel, w1


def jax_conv1(mel, w1, slope=0.2):
    hwio = jnp.asarray(w1.transpose(2, 3, 1, 0))
    return np.asarray(CP.fused_conv1_in(jnp.asarray(mel), hwio, slope=slope,
                                        dtype=jnp.float32, interpret=True), np.float32)


def exact_stats(mel, w1):
    """Mean and rstd of conv1's output computed in fp64 throughout."""
    y = F.conv2d(mel.double()[:, None], w1.double(), padding=1)
    var, mean = torch.var_mean(y, dim=(2, 3), correction=0)
    return mean, torch.rsqrt(var + tconv1.NORM_EPS)


@pytest.mark.parametrize("kind", KINDS)
def test_gram_stats_match_exact_stats(kind):
    mel, w1 = (torch.from_numpy(a) for a in make_inputs(kind, 0, 2, 97))
    mean, rstd = tconv1.conv1_stats_gram(mel, w1)
    ref_mean, ref_rstd = exact_stats(mel, w1)
    assert mean.shape == rstd.shape == (2, 64) and mean.dtype == torch.float32
    # fp64 sums of exact products, rounded to fp32 once
    torch.testing.assert_close(mean.double(), ref_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rstd.double(), ref_rstd, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("width", [427, 37])
@pytest.mark.parametrize("kind", KINDS)
def test_folded_gram_route_matches_plain(kind, width):
    """The kernel's arithmetic (fp64 Gram statistics, norm folded into fp32
    taps) at the fp32 gate of tests/test_conv1_pallas.py, on all three mels."""
    mel, w1 = (torch.from_numpy(a) for a in make_inputs(kind, width, 2, width))
    got = tconv1.conv1_in_folded(mel, w1)
    ref = tconv1.conv1_in_plain(mel, w1)
    assert got.shape == ref.shape == (2, tconv1.ROWS, width, 64)
    assert not got[:, 0].any() and not got[:, -1].any()
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["zero-mean", "power"])
def test_folded_gram_route_matches_jax_kernel(kind):
    mel, w1 = make_inputs(kind, 1, 2, 427)
    got = tconv1.conv1_in_folded(torch.from_numpy(mel), torch.from_numpy(w1)).numpy()
    np.testing.assert_allclose(got, jax_conv1(mel, w1), rtol=2e-5, atol=2e-5)


def test_fp32_moments_lose_digits_where_the_gram_route_holds():
    """At a large offset the fp32 E[y^2] - E[y]^2 of the Pallas kernel (and of
    the port's earlier kernel) misses the fp32 gate; the fp64 Gram route holds
    it, folded taps and all."""
    mel, w1 = make_inputs("offset", 2, 2, 427)
    ref = tconv1.conv1_in_plain(torch.from_numpy(mel), torch.from_numpy(w1)).numpy()
    folded = tconv1.conv1_in_folded(torch.from_numpy(mel), torch.from_numpy(w1)).numpy()
    np.testing.assert_allclose(folded, ref, rtol=2e-5, atol=2e-5)
    jx = jax_conv1(mel, w1)
    assert not np.allclose(jx, ref, rtol=2e-5, atol=2e-5)
    assert np.abs(jx - ref).max() > 10 * np.abs(folded - ref).max()


@pytest.mark.parametrize("slope", [0.0, 1.5])
def test_folded_gram_route_other_slopes(slope):
    """slope 0 (relu) and a slope above 1, where the kernel's lrelu is a min."""
    mel, w1 = (torch.from_numpy(a) for a in make_inputs("power", 3, 1, 64))
    got = tconv1.conv1_in_folded(mel, w1, slope)
    torch.testing.assert_close(got, tconv1.conv1_in_plain(mel, w1, slope), rtol=2e-5, atol=2e-5)
    v = torch.from_numpy(np.random.RandomState(5).randn(4096).astype(np.float32))
    as_max_or_min = torch.maximum(v, slope * v) if slope <= 1 else torch.minimum(v, slope * v)
    torch.testing.assert_close(as_max_or_min, F.leaky_relu(v, slope), rtol=0.0, atol=0.0)


def test_folded_gram_route_bf16_close_to_fp32():
    mel, w1 = (torch.from_numpy(a) for a in make_inputs("offset", 4, 1, 160))
    got = tconv1.conv1_in_folded(mel, w1, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = tconv1.conv1_in_plain(mel, w1)
    assert ((got.float() - ref).abs().mean() / ref.abs().mean()) < 2e-2
