"""The port's tap-shift probe (the plain path of its CUDA kernel) against the
JAX package's probe kernels, run through pl.pallas_call in interpret mode.

bench_profile.py::profile_shift_probe defines its kernel bodies (k_aligned,
k_subtile) as closures, so they are restated here as they stand there; the
call wraps them the same way, at small planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from speechdrivestemplates_tpu_torch.ops import shift_probe as tsp


def jax_shift_probe(x, w, m_out, mode):
    """bench_profile.py:522-548 with M, M_out and C taken from the operands."""
    n_planes, M, C = x.shape

    def k_aligned(x_ref, w_ref, o_ref):
        acc = jnp.zeros((m_out, C), jnp.float32)
        for t in range(9):
            acc += jnp.dot(x_ref[0, :m_out, :], w_ref[t],
                           preferred_element_type=jnp.float32)
        o_ref[0] = acc.astype(jnp.bfloat16)

    def k_subtile(x_ref, w_ref, o_ref):
        acc = jnp.zeros((m_out, C), jnp.float32)
        for t in range(9):
            acc += jnp.dot(x_ref[0, t:t + m_out, :], w_ref[t],
                           preferred_element_type=jnp.float32)
        o_ref[0] = acc.astype(jnp.bfloat16)

    return pl.pallas_call(
        {"aligned": k_aligned, "subtile": k_subtile}[mode],
        grid=(n_planes,),
        in_specs=[pl.BlockSpec((1, M, C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((9, C, C), lambda i: (0, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, m_out, C), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_planes, m_out, C), jnp.bfloat16),
        interpret=True,
    )(x, w)


def make_inputs(rng, n, m, c):
    x = (rng.randn(n, m, c) * 0.1).astype(np.float32)
    w = (rng.randn(9, c, c) * 0.05).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    # the same bf16 values on both sides
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.array(wb.astype(jnp.float32))).to(torch.bfloat16)
    return xb, wb, xt, wt


@pytest.mark.parametrize("mode", ["aligned", "subtile"])
@pytest.mark.parametrize("c", [64, 128])
def test_port_shift_taps_matches_jax_probe(mode, c):
    m, m_out = 48, 32  # the probe's M - 2 * W, at a plane of 3 x 16
    xb, wb, xt, wt = make_inputs(np.random.RandomState(c), 2, m, c)
    ref = np.asarray(jax_shift_probe(xb, wb, m_out, mode).astype(jnp.float32))
    got = tsp.shift_taps(xt, wt, m_out, mode)
    assert got.dtype == torch.bfloat16 and got.shape == (2, m_out, c)
    # both sum exact bf16 products in fp32, in different orders, then round to
    # bf16: at most one bf16 rounding apart
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2, atol=1e-3)


def test_shift_taps_modes_differ_and_check_their_range():
    _, _, xt, wt = make_inputs(np.random.RandomState(7), 1, 24, 64)
    a = tsp.shift_taps_plain(xt, wt, 16, "aligned")
    s = tsp.shift_taps_plain(xt, wt, 16, "subtile")
    assert not torch.equal(a, s)
    # subtile reads rows m + 8: m_out may reach M - 8, aligned may reach M
    assert tsp.shift_taps_plain(xt, wt, 24, "aligned").shape == (1, 24, 64)
    with pytest.raises(ValueError, match="m_out"):
        tsp.shift_taps_plain(xt, wt, 17, "subtile")
    with pytest.raises(ValueError, match="mode"):
        tsp.shift_taps_plain(xt, wt, 16, "diagonal")


def test_shift_kernel_wrapper_rejects_cpu_tensors():
    from speechdrivestemplates_tpu_torch import kernels

    _, _, xt, wt = make_inputs(np.random.RandomState(8), 1, 24, 64)
    before = sum(kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        tsp.shift_taps_kernel(xt, wt, 16, "subtile")
    assert sum(kernels.LAUNCHES.values()) == before
