"""The tap-shift probe: a 9-tap conv-as-matmul over flat (M, C) planes.

    out[n, m] = bf16(sum_t x[n, m + off_t] @ w[t]),   m < m_out,

fp32 accumulation; off_t = 0 for ``mode="aligned"`` (the same view nine
times) or t for ``"subtile"`` (nine views shifted by one row each). No
boundary handling: ``subtile`` needs m_out + 8 <= M. x (N, M, C) and w
(9, C, C) as (tap, C_in, C_out) are bf16, C in {64, 128}.

The counterpart of the JAX package's ``bench_profile.py::profile_shift_probe``
bodies ``k_aligned`` / ``k_subtile``. It exists to measure what shifted views
of one staged window cost, for ``profile_kernels.py``; no model path runs it.
``shift_taps`` is the entry: the CUDA kernel (``csrc/shift_probe.cu``, the op
``torch.ops.sdt.shift_taps``) on CUDA tensors, ``shift_taps_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels

TAPS = 9
MODES = ("aligned", "subtile")
CHANNELS = (64, 128)


def tap_offsets(mode: str) -> list[int]:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    return [t if mode == "subtile" else 0 for t in range(TAPS)]


def _check(x: torch.Tensor, w: torch.Tensor, m_out: int, mode: str) -> None:
    off = max(tap_offsets(mode))
    if x.ndim != 3 or tuple(w.shape) != (TAPS, x.shape[2], x.shape[2]):
        raise ValueError(f"expected x (N, M, C) and w (9, C, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not 1 <= m_out <= x.shape[1] - off:
        raise ValueError(f"m_out {m_out} out of range for M = {x.shape[1]} in "
                         f"{mode} mode (needs m_out + {off} <= M)")


def shift_taps_plain(x: torch.Tensor, w: torch.Tensor, m_out: int,
                     mode: str = "subtile") -> torch.Tensor:
    """Nine fp32 matmuls summed in tap order, then cast to bf16."""
    _check(x, w, m_out, mode)
    acc = None
    for t, o in enumerate(tap_offsets(mode)):
        p = x[:, o:o + m_out].float() @ w[t].float()
        acc = p if acc is None else acc + p
    return acc.to(torch.bfloat16)


def shift_taps_kernel(x: torch.Tensor, w: torch.Tensor, m_out: int,
                      mode: str = "subtile") -> torch.Tensor:
    """The CUDA kernel (wgmma with resident weights, a 2-CTA cluster at C = 128;
    bf16 in, fp32 accumulation); same contract. Forward-only: raises for an
    input that requires grad under grad mode."""
    kernels.refuse_grad("the shift-probe kernel", x, w)
    if x.device.type not in kernels.DEVICE_TYPES or w.device != x.device:
        raise ValueError("shift-probe kernel takes CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"shift-probe kernel takes bf16, got {x.dtype} and {w.dtype}")
    _check(x, w, m_out, mode)
    C = x.shape[2]
    if C not in CHANNELS:
        raise ValueError(f"shift-probe kernel takes C in {CHANNELS}, got {C}")
    return torch.ops.sdt.shift_taps(x, w, int(m_out), mode == "subtile")


def shift_taps(x: torch.Tensor, w: torch.Tensor, m_out: int,
               mode: str = "subtile") -> torch.Tensor:
    """The kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return shift_taps_plain(x, w, m_out, mode)
    return shift_taps_kernel(x, w, m_out, mode)
