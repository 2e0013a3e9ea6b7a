"""The port's audio-encoder stem (the plain path of its fused CUDA kernel)
against the JAX package's fused stem kernel, run in interpret mode on the CPU.

Same inputs and weights as tests/test_stem_pallas.py; the port's function
takes OIHW weights and returns the JAX layout (B, 40, W2, 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probes import stem_pallas as SP
from speechdrivestemplates_tpu_torch.ops import stem as tstem


def make_inputs(rng, batch, width):
    mel = rng.randn(batch, 80, width).astype(np.float32)
    w1 = (rng.randn(3, 3, 1, 64) * 0.2).astype(np.float32)
    w2 = (rng.randn(4, 4, 64, 64) * 0.05).astype(np.float32)
    w3 = (rng.randn(3, 3, 64, 128) * 0.05).astype(np.float32)
    return mel, w1, w2, w3


def port_stem(mel, w1, w2, w3, slope, dtype):
    oihw = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
            for w in (w1, w2, w3)]
    out = tstem.audio_encoder_stem(torch.from_numpy(mel), *oihw, slope=slope,
                                   dtype=dtype)
    return out.float().numpy()


@pytest.mark.parametrize("width", [35, 36, 427, 428])
def test_port_stem_fp32_matches_jax_fused_stem(rng, width):
    mel, w1, w2, w3 = make_inputs(rng, 2, width)
    ref = np.asarray(SP.fused_audio_encoder_stem(
        jnp.asarray(mel), w1, w2, w3, slope=0.2, dtype=jnp.float32, interpret=True))
    got = port_stem(mel, w1, w2, w3, 0.2, torch.float32)
    assert got.shape == ref.shape == (2, 40, tstem.stem_dims(width)[1], 128)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_port_stem_relu_variant(rng):
    mel, w1, w2, w3 = make_inputs(rng, 1, 64)
    ref = np.asarray(SP.fused_audio_encoder_stem(
        jnp.asarray(mel), w1, w2, w3, slope=0.0, dtype=jnp.float32, interpret=True))
    got = port_stem(mel, w1, w2, w3, 0.0, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_port_stem_bf16_close_to_fp32(rng):
    """bf16 convolutions with fp32 statistics stay within the quantile gate of
    tests/test_stem_pallas.py of the fp32 JAX stem (post-IN values are O(1))."""
    mel, w1, w2, w3 = make_inputs(rng, 1, 101)
    ref = np.asarray(SP.fused_audio_encoder_stem(
        jnp.asarray(mel), w1, w2, w3, slope=0.2, dtype=jnp.float32, interpret=True))
    got = port_stem(mel, w1, w2, w3, 0.2, torch.bfloat16)
    err = np.abs(got - ref)
    assert np.quantile(err, 0.99) < 0.05 and err.mean() < 0.02


def test_stem_kernel_wrapper_rejects_cpu_tensors(rng):
    """The kernel entry never runs on the CPU: the dispatcher picks the plain
    version there, and the kernel wrapper itself raises."""
    mel, w1, w2, w3 = make_inputs(rng, 1, 16)
    oihw = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
            for w in (w1, w2, w3)]
    with pytest.raises(ValueError, match="CUDA"):
        tstem.stem_kernel(torch.from_numpy(mel), *oihw)
