"""The generator's time axis split over the ranks: the exact long-form demo.

Counterpart of the JAX package's ``parallel/seqparallel.py``, on the port's
``SequenceGeneratorCNN`` (IN or BN, with or without a clip code) in eval
mode. Each rank holds the whole clip's mel and computes the frames of its own
slice of the time axis; together they reproduce the dense forward at any
length (fp32, ~1e-5):

  * convolutions take their neighbours' edge columns as halos (``_halo``);
    the edge ranks receive zeros, the dense convs' zero padding. Stride-2
    layers stay aligned because every slice is a multiple of the network's
    total stride;
  * the interpolating resizes (``ops/resize.py``) become per-rank banded
    slices of the global interpolation matrix (``make_sharded_resize``), edge
    clamping included;
  * the audio encoder's InstanceNorm-2d normalizes over (H, the global time
    axis): its masked sums are all-reduced (``_instance_norm_2d_global``),
    the VALID (6, 3) conv's two garbage columns on the last rank masked out;
    the 1-D "IN" (a per-position channel norm) and eval-mode BN are local.

The halo exchange is written on ``all_reduce`` (``parallel.dist.exchange``):
each rank writes its edge columns into its slot of a zeroed (world, ...)
buffer, and the sum gives every rank its neighbours' halos. JAX uses
``ppermute``; point-to-point over NCCL needs a card a rank, and gloo on CUDA
tensors is sure of ``all_reduce`` and ``broadcast`` only. The halos are a few
columns, so the buffer is small.

The audio encoder runs as plain torch convolutions with all-reduced IN
statistics, as JAX runs it with ``lax.conv`` here and not with its Pallas
stem: the stem kernels (B3, B2) normalize each sample over its whole width on
one device, so they cannot compute an IN over a time axis split across
ranks. This is JAX's route for the sharded forward, not a fallback. The mel
is the caller's: the demo (``pipelines/voice2pose.py``) computes the whole
padded clip's with the mel kernel (B1) on every rank, as JAX does.

Without a process group (one rank, in process) the halos are zeros and the
statistics local: the forward is the dense one, computed by this route.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.blocks import NORM_EPS, channel_norm_1d
from ..ops.resize import _resize_matrix
from . import dist as pdist


def _halo(x: torch.Tensor, left: int, right: int, dim: int) -> torch.Tensor:
    """``x`` with ``left`` columns of the previous rank and ``right`` of the
    next one concatenated along ``dim``; the edge ranks receive zeros (the
    dense convs' zero padding)."""
    if not (left or right):
        return x
    dim = dim % x.ndim
    n, r = pdist.world_size(), pdist.rank()
    width = x.shape[dim]
    edges = [x.narrow(dim, width - left, left), x.narrow(dim, 0, right)]
    # one slot a rank: its last `left` columns, then its first `right` ones
    slots = pdist.exchange(torch.cat(edges, dim).float()).to(x.dtype)
    shape = list(x.shape)
    parts = []
    if left:
        shape[dim] = left
        parts.append(slots[r - 1].narrow(dim, 0, left) if r > 0 else x.new_zeros(shape))
    parts.append(x)
    if right:
        shape[dim] = right
        parts.append(slots[r + 1].narrow(dim, left, right) if r < n - 1
                     else x.new_zeros(shape))
    return torch.cat(parts, dim)


# ---- the banded resize --------------------------------------------------------------

def make_sharded_resize(in_len: int, out_len: int, n: int,
                        valid_src: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Per-rank slices of the global (out_len, in_len) interpolation matrix.

    Returns (stacked (n, out_l, in_l + 2*halo) float32 array, halo). When
    ``valid_src`` < in_len the trailing source columns are garbage (the VALID
    conv's tail) and their weights are zero by construction.
    """
    assert in_len % n == 0 and out_len % n == 0, (in_len, out_len, n)
    in_l, out_l = in_len // n, out_len // n
    src_cols = in_len if valid_src is None else valid_src
    if src_cols <= 0:
        raise ValueError(
            f"no valid source columns to resize from (valid_src={valid_src}): "
            f"the clip is too short for a {n}-way sequence-parallel forward")
    W = _resize_matrix(src_cols, out_len)  # (out_len, src_cols)
    if src_cols < in_len:
        W = np.concatenate([W, np.zeros((out_len, in_len - src_cols), np.float32)], axis=1)

    # the least halo: the farthest any rank's rows reach beyond its own columns
    halo = 0
    for s in range(n):
        rows = W[s * out_l:(s + 1) * out_l]
        cols = np.nonzero(np.abs(rows).sum(axis=0) > 0)[0]
        if len(cols):
            halo = max(halo, s * in_l - cols.min(), cols.max() - ((s + 1) * in_l - 1))
    halo = int(max(halo, 0))
    if halo > in_l:
        # _halo exchanges with the adjacent ranks only, so a halo wider than
        # one slice cannot be met: the clip is much shorter than the ranks
        raise ValueError(
            f"sequence-parallel halo ({halo}) exceeds the per-shard width "
            f"({in_l}) for a {n}-way resize {in_len}->{out_len}: the clip is "
            "too short to shard this many ways — use the dense demo path "
            "(DEMO.SEQUENCE_PARALLEL False) or fewer devices")

    mats = np.zeros((n, out_l, in_l + 2 * halo), np.float32)
    for s in range(n):
        lo, hi = s * in_l - halo, (s + 1) * in_l + halo
        src = W[s * out_l:(s + 1) * out_l, max(lo, 0):min(hi, in_len)]
        dst_lo = max(lo, 0) - lo
        mats[s, :, dst_lo:dst_lo + src.shape[1]] = src
    return mats, halo


def sharded_resize_time(x: torch.Tensor, mats: np.ndarray, halo: int) -> torch.Tensor:
    """A ``make_sharded_resize`` result applied along the last (time) axis of
    this rank's (..., T_l) slice."""
    x_ext = _halo(x, halo, halo, -1) if halo else x
    M = torch.from_numpy(mats[pdist.rank()]).to(x.device, x.dtype)
    return x_ext @ M.T


@functools.lru_cache(maxsize=16)
def _resize_plan(t_mel: int, num_frames: int, n: int):
    """The banded resizes of one (clip, ranks) shape: the audio encoder's
    grid to the frame grid, and the UNet's five upsamples. Built before any
    collective, so a clip too short for ``n`` ranks raises on every rank
    alike."""
    w_valid = t_mel // 8 - 2  # the encoder grid after 3 downsamples and the VALID conv
    resize_ae = make_sharded_resize(t_mel // 8, num_frames, n, valid_src=w_valid)
    resize_up, t = [], num_frames // 32
    for _ in range(5):
        resize_up.append(make_sharded_resize(t, 2 * t, n))
        t *= 2
    return resize_ae, resize_up


# ---- the sharded layers ---------------------------------------------------------------

def _conv_time(layer, x: torch.Tensor) -> torch.Tensor:
    """A ``ConvNormRelu``'s convolution with its padding along the global
    time axis as halos, VALID on the slice; a 2-D one pads H locally."""
    c = layer.conv
    k_t, p_t = c.kernel_size[-1], c.padding[-1]
    x_ext = _halo(x, p_t, k_t - 1 - p_t, -1).to(layer.dtype)
    w = c.weight.to(layer.dtype)
    if layer.conv_type == "2d":
        return F.conv2d(x_ext, w, stride=c.stride, padding=(c.padding[0], 0))
    return F.conv1d(x_ext, w, stride=c.stride)


def _instance_norm_2d_global(y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """IN-2d over (H, the global W) per (B, C) of this rank's (B, C, H, W_l)
    slice: the masked sums all-reduced, in two passes; the masked (garbage)
    columns come out 0. ``mask`` is (W_l,) in {0, 1}."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    m = mask.to(yf.dtype).view(1, 1, 1, -1)
    cnt = pdist.all_reduce_sum(m.sum() * y.shape[2])
    mean = pdist.all_reduce_sum((yf * m).sum(dim=(2, 3), keepdim=True)) / cnt
    var = pdist.all_reduce_sum((((yf - mean) ** 2) * m).sum(dim=(2, 3), keepdim=True)) / cnt
    return (yf - mean) * torch.rsqrt(var + NORM_EPS) * m


def _cnr(layer, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``ConvNormRelu`` (eval mode) on this rank's slice: eval-mode BN is
    a local affine of the running statistics; a 2-D IN's statistics are the
    global axis's; the 1-D IN normalizes each position's channels, locally."""
    y = _conv_time(layer, x)
    if layer.norm is not None:
        y = layer.norm(y)
    elif layer.conv_type == "2d":
        y = _instance_norm_2d_global(y, torch.ones(y.shape[-1], device=y.device)
                                     if mask is None else mask)
    else:
        y = channel_norm_1d(y)
    return F.leaky_relu(y, layer.slope).to(layer.dtype)


def _generator_seq_forward(gen, mel: torch.Tensor, code: Optional[torch.Tensor],
                           resize_ae, resize_up) -> torch.Tensor:
    """This rank's slice of the generator's forward: mel (B, 80, T_mel_l) ->
    (B, T_l, 2, K)."""
    enc = gen.audio_encoder.layers()
    x = mel[:, None]  # (B, 1, 80, T_mel_l)
    for layer in enc[:7]:
        x = _cnr(layer, x)
    # the (6, 3) VALID conv: halo (0, 2); the last rank's last 2 columns are garbage
    n, r = pdist.world_size(), pdist.rank()
    wl = x.shape[-1]
    mask = torch.ones(wl, device=x.device)
    if r == n - 1:
        mask[wl - 2:] = 0
    x = _cnr(enc[7], x, mask) * mask.to(enc[7].dtype)
    # bilinear (H' -> 1, W' -> T): H by a local matmul, W by the banded resize,
    # whose matrix gives the garbage columns no weight
    Wh = torch.from_numpy(_resize_matrix(x.shape[2], 1)).to(x.device, x.dtype)
    x = (Wh @ x)[:, :, 0, :]  # (B, 256, W_l)
    x = sharded_resize_time(x, *resize_ae)  # (B, 256, T_l)

    if (code is None) != (gen.code_dim is None):
        e0_in = gen.unet.e0.conv.weight.shape[1]
        raise ValueError(
            f"generator expects {e0_in} UNet input channels but got "
            f"{x.shape[1] + (0 if code is None else code.shape[-1])}: pass `code` iff the "
            "checkpoint was trained with CLIP_CODE.DIMENSION set (and with the same "
            "dimension)")
    if code is not None:
        x = torch.cat([x, code[:, :, None].expand(-1, -1, x.shape[-1]).to(x.dtype)], dim=1)

    u = gen.unet
    e0 = _cnr(u.e0, x)
    e1 = _cnr(u.e1, e0)
    e2 = _cnr(u.e2, e1)
    e3 = _cnr(u.e3, e2)
    e4 = _cnr(u.e4, e3)
    e5 = _cnr(u.e5, e4)
    d = _cnr(u.e6, e5)
    for lvl, (layer, skip) in enumerate([(u.d5, e5), (u.d4, e4), (u.d3, e3), (u.d2, e2),
                                          (u.d1, e1)]):
        d = _cnr(layer, sharded_resize_time(d, *resize_up[lvl]) + skip)
    for layer in gen.decoder[:4]:
        d = _cnr(layer, d)
    out = gen.decoder[4]
    d = F.conv1d(d, out.weight.to(gen.dtype), out.bias.to(gen.dtype))
    return d.transpose(1, 2).reshape(d.shape[0], d.shape[2], 2, gen.num_landmarks)


@torch.no_grad()
def generator_seq_parallel(gen, mel: torch.Tensor, num_frames: int,
                           code: Optional[torch.Tensor] = None,
                           norm: Optional[str] = None) -> torch.Tensor:
    """The dense ``SequenceGeneratorCNN`` eval forward with the time axis
    split over the ranks. ``mel`` (B, 80, T_mel) is the whole clip's, on
    every rank; ``code`` (B, code_dim) or None. Returns the whole (B,
    num_frames, 2, K) on every rank (the ranks' frames gathered). ``norm``
    (default: the generator's) must be the generator's 'IN' or 'BN'.

    Constraints (asserted): T_mel divisible by 8 * ranks, num_frames by
    32 * ranks. A clip too short for the ranks raises ValueError
    (``make_sharded_resize``) before any collective.
    """
    n = pdist.world_size()
    t_mel = mel.shape[-1]
    assert t_mel % (8 * n) == 0, (t_mel, n)
    assert num_frames % (32 * n) == 0, (num_frames, n)
    if norm is None:
        norm = gen.audio_encoder.norm
    if norm not in ("BN", "IN"):
        raise ValueError(f"unknown norm {norm!r}; expected 'BN' or 'IN'")
    if norm != gen.audio_encoder.norm:
        raise ValueError(f"norm {norm!r}: the generator's layers are "
                         f"{gen.audio_encoder.norm!r}-normalized")
    resize_ae, resize_up = _resize_plan(t_mel, num_frames, n)
    t_l = t_mel // n
    r = pdist.rank()
    was = gen.training
    gen.eval()
    try:
        out = _generator_seq_forward(gen, mel[..., r * t_l:(r + 1) * t_l], code, resize_ae,
                                     resize_up)
    finally:
        gen.train(was)
    return pdist.gather_rows(out.float(), dim=1).to(out.dtype)
