"""The six kernels as ``torch.library`` custom ops, namespace ``sdt``.

    sdt::mel(audio, cs_hi, cs_lo, fb_hi, fb_lo)  (B, L) f32 -> (B, 80, L//160+1) f32
    sdt::conv1_in(mel, w1, slope, dtype)         (B, 80, W1) f32 -> (B, 82, W1, 64) dtype
    sdt::stem(y1, w2t, w3t, slope)               (B, 82, W1, 64) -> (B, 40, W2, 128), y1's dtype
    sdt::shift_taps(x, w, m_out, subtile)        (N, M, C) bf16 -> (N, m_out, C) bf16
    sdt::bn_act(x, running_mean, running_var, weight, bias, slope)
                                                 (B, C, ...) dtype -> the same shape, dtype,
                                                 and strides where channels-last
    sdt::in_act(x, slope)                        (B, C, H, W) or (B, C, T) dtype -> the same
                                                 shape and strides, dtype
    sdt::in_act_stats(x, slope)                  in_act's output, and the fp32 mean and
                                                 variance it used, (B, C) or (B, T) each

``in_act_stats`` launches the same kernel as ``in_act`` and lets tests read
its statistics; the serving route calls ``in_act``.

Each op is a schema on one ``torch.library.Library`` with two
registrations (``torch.library.custom_op`` would add a Python autograd and
dispatch layer to every call, which a B = 1 request pays three times): a CUDA
implementation, which allocates its output and scratch, launches the kernel
through ``ctypes`` on the current stream and counts the launch in
``LAUNCHES``, and a fake implementation, which gives the output's
shape and dtype and launches nothing: ``torch.export`` traces the ops with
fake tensors, which have no data pointer, and the exported graph calls them.
Every operand a kernel reads is an op input (mel's split DFT and filterbank
tables, the stem's weights as (kh, kw, C_out, C_in), a BN layer's four
vectors), so that an exported graph carries them as constants. The wrappers
in ``ops/`` check their inputs and call ``torch.ops.sdt.*``; the
implementations take the dense layout the kernels read (``contiguous()``,
free where the wrapper made it so, and a copy where a graph hands them
another; ``bn_act`` and ``in_act`` also read a channels-last activation as it
is, and give theirs in the same layout). The ops have no autograd formula:
the wrappers refuse an input that requires grad first.
"""

from __future__ import annotations

import math

import torch

from . import LAUNCHES, LAYOUTS, check, current_stream, library

N_MELS = 80
HOP_LENGTH = 160
CONV1_ROWS = 82   # conv1's 80 output rows, zero rows 0 and 81 around them
C1, C3 = 64, 128  # conv1 / conv2 channels, conv3 channels
CONV_TILE = 128   # output pixels per tile of the stem's convs (csrc/stem.cu: TM)


def stem_dims(w1: int) -> tuple[int, int]:
    """(H2, W2): conv2's and conv3's output height and width."""
    return (N_MELS - 2) // 2 + 1, (w1 - 2) // 2 + 1


LIB = torch.library.Library("sdt", "DEF")  # the registrations live as long as it does
LIB.define("mel(Tensor audio, Tensor cs_hi, Tensor cs_lo, Tensor fb_hi, Tensor fb_lo) -> Tensor")
LIB.define("conv1_in(Tensor mel, Tensor w1, float slope, ScalarType dtype) -> Tensor")
LIB.define("stem(Tensor y1, Tensor w2t, Tensor w3t, float slope) -> Tensor")
LIB.define("shift_taps(Tensor x, Tensor w, int m_out, bool subtile) -> Tensor")
LIB.define("bn_act(Tensor x, Tensor running_mean, Tensor running_var, Tensor weight, "
           "Tensor bias, float slope) -> Tensor")
LIB.define("in_act(Tensor x, float slope) -> Tensor")
LIB.define("in_act_stats(Tensor x, float slope) -> (Tensor, Tensor, Tensor)")


@torch.library.impl("sdt::mel", "CUDA", lib=LIB)
def mel(audio, cs_hi, cs_lo, fb_hi, fb_lo):
    audio, cs_hi, cs_lo, fb_hi, fb_lo = (t.contiguous() for t in (audio, cs_hi, cs_lo,
                                                                   fb_hi, fb_lo))
    B, L = audio.shape
    T = L // HOP_LENGTH + 1
    out = torch.empty((B, N_MELS, T), dtype=torch.float32, device=audio.device)
    err = library("mel").sdt_mel_forward(
        audio.data_ptr(), cs_hi.data_ptr(), cs_lo.data_ptr(), fb_hi.data_ptr(),
        fb_lo.data_ptr(), out.data_ptr(), B, L, T, current_stream(audio.device))
    LAUNCHES["mel"] += 1
    check(err, "sdt_mel_forward")
    return out


@torch.library.register_fake("sdt::mel", lib=LIB)
def _(audio, cs_hi, cs_lo, fb_hi, fb_lo):
    B, L = audio.shape
    return audio.new_empty((B, N_MELS, L // HOP_LENGTH + 1), dtype=torch.float32)


@torch.library.impl("sdt::conv1_in", "CUDA", lib=LIB)
def conv1_in(mel, w1, slope, dtype):
    mel, w1 = mel.contiguous(), w1.contiguous()
    B, _, W1 = mel.shape
    dev = mel.device
    taps = torch.empty(B * 10 * C1, dtype=torch.float32, device=dev)  # folded taps + bias
    out = torch.empty((B, CONV1_ROWS, W1, C1), dtype=dtype, device=dev)
    err = library("conv1").sdt_conv1_in_forward(
        mel.data_ptr(), w1.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
        taps.data_ptr(), B, W1, float(slope), current_stream(dev))
    LAUNCHES["conv1"] += 1
    check(err, "sdt_conv1_in_forward")
    return out


@torch.library.register_fake("sdt::conv1_in", lib=LIB)
def _(mel, w1, slope, dtype):
    B, _, W1 = mel.shape
    return mel.new_empty((B, CONV1_ROWS, W1, C1), dtype=dtype)


@torch.library.impl("sdt::stem", "CUDA", lib=LIB)
def stem(y1, w2t, w3t, slope):
    y1, w2t, w3t = y1.contiguous(), w2t.contiguous(), w3t.contiguous()
    B, _, W1, _ = y1.shape
    H2, W2 = stem_dims(W1)
    dev, dtype = y1.device, y1.dtype
    f32 = dict(dtype=torch.float32, device=dev)
    parts = B * H2 * -(-W2 // CONV_TILE) * 2 * C3  # per tile and warpgroup (bf16)
    # conv2's and conv3's raw outputs, in the compute dtype
    y2 = torch.empty((B, H2, W2, C1), dtype=dtype, device=dev)
    y3 = torch.empty((B, H2, W2, C3), dtype=dtype, device=dev)
    psum, psq = torch.empty(parts, **f32), torch.empty(parts, **f32)
    mean, rstd = torch.empty(B * C3, **f32), torch.empty(B * C3, **f32)
    out = torch.empty((B, H2, W2, C3), dtype=dtype, device=dev)
    err = library("stem").sdt_stem_forward(
        y1.data_ptr(), int(dtype == torch.bfloat16), w2t.data_ptr(), w3t.data_ptr(),
        out.data_ptr(), y2.data_ptr(), y3.data_ptr(), psum.data_ptr(),
        psq.data_ptr(), mean.data_ptr(), rstd.data_ptr(), B, W1, float(slope),
        current_stream(dev))
    LAUNCHES["stem"] += 1
    check(err, "sdt_stem_forward")
    return out


@torch.library.register_fake("sdt::stem", lib=LIB)
def _(y1, w2t, w3t, slope):
    B, _, W1, _ = y1.shape
    H2, W2 = stem_dims(W1)
    return y1.new_empty((B, H2, W2, C3))


@torch.library.impl("sdt::shift_taps", "CUDA", lib=LIB)
def shift_taps(x, w, m_out, subtile):
    x, w = x.contiguous(), w.contiguous()
    N, M, C = x.shape
    out = torch.empty((N, m_out, C), dtype=torch.bfloat16, device=x.device)
    err = library("shift_probe").sdt_shift_taps_forward(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), N, M, m_out, C, int(subtile),
        current_stream(x.device))
    LAUNCHES["shift_probe"] += 1
    check(err, "sdt_shift_taps_forward")
    return out


@torch.library.register_fake("sdt::shift_taps", lib=LIB)
def _(x, w, m_out, subtile):
    N, _, C = x.shape
    return x.new_empty((N, m_out, C), dtype=torch.bfloat16)


def bn_act_slab(x: torch.Tensor):
    """``(N, C, S)``: ``x`` as the dense slab the BN kernel reads, the channel
    of element e being (e / S) mod C: a channels-last (B, C, H, W) as (B x H x
    W, C, 1), a contiguous (B, C, ...) as (B, C, the rest's product). None for
    another layout."""
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        B, C, H, W = x.shape
        return B * H * W, C, 1
    if x.is_contiguous():
        return x.shape[0], x.shape[1], math.prod(x.shape[2:])
    return None


def bn_act_layout(x: torch.Tensor) -> str:
    """The key ``bn_act`` counts a call under in ``LAYOUTS``: the layout it
    was handed."""
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return "contiguous" if x.is_contiguous() else "strided"  # strided: copied first


@torch.library.impl("sdt::bn_act", "CUDA", lib=LIB)
def bn_act(x, running_mean, running_var, weight, bias, slope):
    layout = bn_act_layout(x)
    if bn_act_slab(x) is None:
        x = x.contiguous()
    N, C, S = bn_act_slab(x)
    vecs = [t.contiguous() for t in (running_mean, running_var, weight, bias)]
    out = torch.empty_like(x)  # x's strides
    err = library("bn_act").sdt_bn_act_forward(
        x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in vecs),
        int(x.dtype == torch.bfloat16), N, C, S, float(slope), current_stream(x.device))
    LAUNCHES["bn_act"] += 1
    LAYOUTS["bn_act", layout] += 1
    check(err, "sdt_bn_act_forward")
    return out


@torch.library.register_fake("sdt::bn_act", lib=LIB)
def _(x, running_mean, running_var, weight, bias, slope):
    return torch.empty_like(x) if bn_act_slab(x) is not None else x.new_empty(x.shape)


def in_act_slab(x: torch.Tensor):
    """``(N, R, K)``: ``x`` as the dense slab whose N x K columns the IN
    kernel normalizes over R, K contiguous: a channels-last (B, C, H, W) as
    (B, H x W, C), a contiguous one as (B x C, H x W, 1), a contiguous (B, C,
    T) as itself (the 1-D norm over C). None for another layout."""
    if x.ndim == 4:
        B, C, H, W = x.shape
        if x.is_contiguous(memory_format=torch.channels_last):
            return B, H * W, C
        if x.is_contiguous():
            return B * C, H * W, 1
    elif x.ndim == 3 and x.is_contiguous():
        return tuple(x.shape)
    return None


def _in_act(x, slope, stats):
    if in_act_slab(x) is None:
        x = x.contiguous()
    N, R, K = in_act_slab(x)
    out = torch.empty_like(x)  # x's strides
    mean, var = (_in_act_stat(x) for _ in range(2)) if stats else (None, None)
    err = library("in_act").sdt_in_act_forward(
        x.data_ptr(), out.data_ptr(), mean.data_ptr() if stats else None,
        var.data_ptr() if stats else None, int(x.dtype == torch.bfloat16), N, R, K,
        float(slope), current_stream(x.device))
    LAUNCHES["in_act"] += 1
    check(err, "sdt_in_act_forward")
    return out, mean, var


def _in_act_stat(x):
    """A column statistic's (B, C) or (B, T), fp32."""
    cols = x.shape[1] if x.ndim == 4 else x.shape[2]
    return torch.empty((x.shape[0], cols), dtype=torch.float32, device=x.device)


def _in_act_fake(x):
    return torch.empty_like(x) if in_act_slab(x) is not None else x.new_empty(x.shape)


@torch.library.impl("sdt::in_act", "CUDA", lib=LIB)
def in_act(x, slope):
    return _in_act(x, slope, False)[0]


@torch.library.register_fake("sdt::in_act", lib=LIB)
def _(x, slope):
    return _in_act_fake(x)


@torch.library.impl("sdt::in_act_stats", "CUDA", lib=LIB)
def in_act_stats(x, slope):
    return _in_act(x, slope, True)


@torch.library.register_fake("sdt::in_act_stats", lib=LIB)
def _(x, slope):
    return _in_act_fake(x), _in_act_stat(x), _in_act_stat(x)
