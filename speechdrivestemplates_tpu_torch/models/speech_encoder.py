"""A speech-transformer audio encoder (HuBERT Large) and the SDT generator
that takes its features in place of the mel CNN's.

``SpeechEncoder`` is HuBERT's encoder as Hsu et al. publish it (HuBERT,
IEEE/ACM TASLP 2021; ``facebook/hubert-large-ll60k``'s ``config.json``), at the
widths of ``HUBERT_LARGE``, the one table of them (``SpeechEncoderSpec``, whose
fields are the config's keys):

- feature encoder: seven ``Conv1d`` with bias over the raw waveform, each
  followed by a LayerNorm over its channels and GELU (on the card, in a
  forward that takes no gradient, the bias, LayerNorm and GELU run as one
  kernel after a convolution without its bias: ``ops/ln_gelu.py``);
- feature projection: LayerNorm, then Linear to the hidden size;
- positional convolution: a grouped ``Conv1d`` under weight norm (``dim=2``),
  "same" padded (an even kernel's last frame dropped), GELU, added to its
  input; computed as a product of spectra in float32 (``pos_conv``): at
  k = 128 in 16 groups cuDNN runs it in a slow legacy kernel;
- pre-LN transformer layers, ``x += Attn(LN(x))`` (full, bidirectional, with
  biases) and ``x += W2 GELU(W1 LN(x))``, then a final LayerNorm.

Submodules and parameters are named after transformers' ``HubertModel``
state dict (the public checkpoint's: the positional convolution's
``weight_g`` and ``weight_v``), without ``masked_spec_embed``, which only
pretraining's masking reads; the generator holds the encoder as
``audio_encoder``.

``SequenceGeneratorHuBERT`` is SDT-BP's generator with this encoder: the
encoder, Linear(hidden -> 256), the resize to the video frames that the CNN
encoder ends with, then the code concat, ``UNet1D`` and the decoder of
``SequenceGeneratorCNN`` (its ``decode``). Its ``features`` hook takes each
clip's waveform to zero mean and unit variance, as HuBERT's feature
extractor does; the mel is not computed.

Precision: the weights are float32 parameters; a forward computes in the
compute dtype (bf16 on the card), norms and softmax accumulating in float32
inside torch's kernels. A forward that cannot take a gradient (eval mode
with autograd off: serving, the eval and demo steps) reads the weights from a
cache made once, at load: weight norm folded into the effective weight, the
attention's Q, K and V weights stacked into one matrix, the convolutions'
weights laid out channels-last, each cast to the compute dtype. The feature
encoder keeps its activations (B, T, C), which its convolutions read as
(B, C, 1, T) channels-last. A load refreshes the cache in place, so a CUDA graph that read
it reads the new weights; a parameter changed otherwise (a train step) is
seen by its version and refreshed at the next such forward. Every other
forward computes the same tensors from the parameters under autograd.

Attention is ``scaled_dot_product_attention`` with its backend fixed by one
rule: flash attention where the card computes in bf16 or fp16 and ``plain``
is off, else the math backend. The backend is forced, so the card never falls
back to math silently: a shape flash cannot take raises. Each call that the
host runs (eager, or once at a graph's capture) counts in
``kernels.ATTENTION`` by backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import kernels
from ..ops.ln_gelu import ln_gelu_kernel
from ..ops.resize import interpolate_linear_time
from ..utils import trace
from .generator import SequenceGeneratorCNN

NORMALIZE_EPS = 1e-7  # HuBERT's feature extractor's variance floor
AUDIO_CHANNELS = 256  # what SDT's UNet takes from the audio, beside the code


@dataclass(frozen=True)
class SpeechEncoderSpec:
    """The encoder's widths, under the published config's keys."""
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


HUBERT_LARGE = SpeechEncoderSpec()


def normalize_waveform(audio: torch.Tensor) -> torch.Tensor:
    """(B, L) -> each clip at zero mean and unit variance, float32."""
    x = audio.float()
    var, mean = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + NORMALIZE_EPS)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              plain: bool = False) -> torch.Tensor:
    """Full bidirectional attention of (B, heads, T, head_dim) tensors through
    SDPA, its backend by the module's rule, counted in ``kernels.ATTENTION``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    flash = q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) and not plain
    backend = SDPBackend.FLASH_ATTENTION if flash else SDPBackend.MATH
    with sdpa_kernel(backend):
        out = F.scaled_dot_product_attention(q, k, v)
    kernels.ATTENTION["flash" if flash else "math"] += 1
    return out


def pos_conv(x: torch.Tensor, w: torch.Tensor, groups: int) -> torch.Tensor:
    """HuBERT's positional convolution of (B, T, H) ``x`` with the grouped
    weight ``w`` (H, H / groups, k), no bias: padded by k // 2 on each side,
    an even kernel's last frame dropped, so ``y[t] = sum_j w[j] x[t + j - k //
    2]``. Computed as a product of spectra in float32: the real FFT of the
    frames and of the taps over n >= T + k - 1 points (a circular
    convolution that long is the linear one), each group's channels mixed by a
    matmul at each frequency. -> (B, T, H) float32."""
    n, t, h = x.shape
    k, c = w.shape[-1], h // groups
    nfft = 1 << (t + k - 2).bit_length()
    # tap j at lag k // 2 - j (mod nfft): the kernel flipped, from lag k // 2 - k + 1
    taps = torch.roll(F.pad(w.float().flip(-1), (0, nfft - k)), k // 2 - k + 1, dims=-1)
    wf = torch.fft.rfft(taps).view(groups, c, c, -1).permute(0, 3, 2, 1)  # (G, F, in, out)
    xf = torch.fft.rfft(x.float().transpose(1, 2), n=nfft)  # (B, H, F)
    xf = xf.view(n, groups, c, -1).permute(1, 3, 0, 2)  # (G, F, B, in)
    yf = torch.matmul(xf, wf).permute(2, 0, 3, 1).reshape(n, h, -1)  # (B, H, F)
    return torch.fft.irfft(yf, n=nfft)[..., :t].transpose(1, 2)


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride, bias=True)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)


class _FeatureEncoder(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        c_in, layers = 1, []
        for c, k, s in zip(spec.conv_dim, spec.conv_kernel, spec.conv_stride):
            layers.append(_ConvLayer(c_in, c, k, s, spec.layer_norm_eps))
            c_in = c
        self.conv_layers = nn.ModuleList(layers)


class _FeatureProjection(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        self.layer_norm = nn.LayerNorm(spec.conv_dim[-1], eps=spec.layer_norm_eps)
        self.projection = nn.Linear(spec.conv_dim[-1], spec.hidden_size)


class _WeightNormConv(nn.Module):
    """A grouped Conv1d's parameters under weight norm over dim 2: the
    effective weight is ``weight_g * weight_v / ||weight_v||``, the norm over
    every axis but the kernel's."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(torch.empty(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = groups

    def weight(self) -> torch.Tensor:
        return torch._weight_norm(self.weight_v, self.weight_g, 2)


class _PosConvEmbed(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        self.conv = _WeightNormConv(spec.hidden_size, spec.num_conv_pos_embeddings,
                                    spec.num_conv_pos_embedding_groups)


class _Attention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.k_proj, self.v_proj, self.q_proj, self.out_proj = (nn.Linear(h, h)
                                                                for _ in range(4))


class _FeedForward(nn.Module):
    def __init__(self, h: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(h, inner)
        self.output_dense = nn.Linear(inner, h)


class _Layer(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        h, eps = spec.hidden_size, spec.layer_norm_eps
        self.attention = _Attention(h)
        self.layer_norm = nn.LayerNorm(h, eps=eps)
        self.feed_forward = _FeedForward(h, spec.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(h, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(spec)
        self.layer_norm = nn.LayerNorm(spec.hidden_size, eps=spec.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(spec) for _ in range(spec.num_hidden_layers))


class SpeechEncoder(nn.Module):
    """Normalized waveform (B, L) -> hidden states (B, T, hidden_size) in the
    compute dtype; the module's docstring."""

    def __init__(self, spec: SpeechEncoderSpec = HUBERT_LARGE,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        with torch.device("meta"):  # no default init: ``_init`` sets every parameter
            self.feature_extractor = _FeatureEncoder(spec)
            self.feature_projection = _FeatureProjection(spec)
            self.encoder = _Encoder(spec)
        if not torch.empty(0).is_meta:
            self.to_empty(device="cpu")
            self._init(generator or torch.Generator().manual_seed(0))
        self._cache, self._cache_key = None, None
        self.register_load_state_dict_post_hook(_refresh_after_load)

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        """HuBERT's init: linears N(0, 0.02), convolutions Kaiming-normal, the
        positional convolution N(0, 2 / sqrt(kernel x channels a group)) with
        ``weight_g`` its norm, LayerNorms (1, 0), biases 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(m, nn.Conv1d):
                fan_in = m.weight.shape[1] * m.weight.shape[2]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
            elif isinstance(m, _WeightNormConv):
                fan_in = m.weight_v.shape[1] * m.weight_v.shape[2]
                m.weight_v.normal_(0.0, 2.0 * math.sqrt(1.0 / fan_in), generator=gen)
                m.weight_g.copy_(torch.linalg.vector_norm(m.weight_v, dim=(0, 1), keepdim=True))
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.LayerNorm, _WeightNormConv)):
                m.bias.zero_()

    def _weights(self) -> tuple:
        """The tensors a forward computes with, from the parameters, in the
        compute dtype but the positional convolution's folded weight (float32):
        (conv layers, projection, positional conv, layers, final LN)."""
        def c(t):
            return t.to(self.dtype)

        # each (C_out, C_in, k) weight as (C_out, C_in, 1, k) channels-last
        convs = [(c(m.conv.weight).unsqueeze(2).contiguous(memory_format=torch.channels_last),
                  c(m.conv.bias), c(m.layer_norm.weight), c(m.layer_norm.bias))
                 for m in self.feature_extractor.conv_layers]
        fp = self.feature_projection
        proj = (c(fp.layer_norm.weight), c(fp.layer_norm.bias), c(fp.projection.weight),
                c(fp.projection.bias))
        pc = self.encoder.pos_conv_embed.conv
        pos = (pc.weight().float(), c(pc.bias))
        layers = []
        for m in self.encoder.layers:
            a, f = m.attention, m.feed_forward
            qkv = [a.q_proj, a.k_proj, a.v_proj]
            layers.append((c(m.layer_norm.weight), c(m.layer_norm.bias),
                           c(torch.cat([p.weight for p in qkv])),
                           c(torch.cat([p.bias for p in qkv])),
                           c(a.out_proj.weight), c(a.out_proj.bias),
                           c(m.final_layer_norm.weight), c(m.final_layer_norm.bias),
                           c(f.intermediate_dense.weight), c(f.intermediate_dense.bias),
                           c(f.output_dense.weight), c(f.output_dense.bias)))
        ln = self.encoder.layer_norm
        return convs, proj, pos, layers, (c(ln.weight), c(ln.bias))

    def _key(self) -> tuple:
        return (self.dtype,) + tuple((p._version, p.device) for p in self.parameters())

    def _refresh(self) -> None:
        """Make the cache again from the parameters (in place where it exists
        at the same shapes and device); dropped in train mode."""
        if self.training:
            self._cache, self._cache_key = None, None
            return
        with torch.inference_mode(False), torch.no_grad():
            new = self._weights()
            flat_new = _flatten(new)
            old = None if self._cache is None else _flatten(self._cache)
            if old is not None and all(a.shape == b.shape and a.device == b.device
                                       and a.dtype == b.dtype for a, b in zip(old, flat_new)):
                for a, b in zip(old, flat_new):
                    a.copy_(b)
            else:
                self._cache = new
        self._cache_key = self._key()

    def weights(self) -> tuple:
        """``_weights()``: from the cache where the forward takes no gradient."""
        if self.training or torch.is_grad_enabled():
            return self._weights()
        if self._cache is None or self._cache_key != self._key():
            self._refresh()
        return self._cache

    def forward(self, audio: torch.Tensor, plain: bool = False) -> torch.Tensor:
        spec = self.spec
        convs, (pln_w, pln_b, proj_w, proj_b), (pos_w, pos_b), layers, (ln_w, ln_b) = \
            self.weights()
        eps, h = spec.layer_norm_eps, spec.hidden_size
        # the conv stack's bias, LayerNorm and GELU in one kernel: on the card,
        # in a forward that takes no gradient, unless asked for the plain path
        fused = (audio.device.type in kernels.DEVICE_TYPES and not plain
                 and not (self.training or torch.is_grad_enabled()))
        with trace.span("encoder.features"):
            x = audio.to(self.dtype)[:, :, None]  # (B, L, 1)
            for (w, b, g, beta), stride in zip(convs, spec.conv_stride):
                # (B, T, C) read as (B, C, 1, T) channels-last: the convolution
                # reads and writes that layout and the LayerNorm's channels are
                # the inner axis, so no activation is transposed
                y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w, None if fused else b,
                             stride=(1, stride))
                y = y.squeeze(2).transpose(1, 2)
                if fused:  # contiguous: free where cuDNN wrote channels-last, as on the card
                    x = ln_gelu_kernel(y.contiguous(), b, g, beta, eps)
                else:
                    x = F.gelu(F.layer_norm(y, (y.shape[-1],), g, beta, eps))
            x = F.linear(F.layer_norm(x, (x.shape[-1],), pln_w, pln_b, eps), proj_w, proj_b)
        with trace.span("encoder.transformer"):
            n, t = x.shape[:2]
            pos = pos_conv(x, pos_w, spec.num_conv_pos_embedding_groups) + pos_b
            x = x + F.gelu(pos.to(self.dtype))
            heads = spec.num_attention_heads
            for (a_w, a_b, qkv_w, qkv_b, o_w, o_b, f_w, f_b, w1, b1, w2, b2) in layers:
                qkv = F.linear(F.layer_norm(x, (h,), a_w, a_b, eps), qkv_w, qkv_b)
                q, k, v = qkv.view(n, t, 3, heads, h // heads).permute(2, 0, 3, 1, 4)
                a = attention(q, k, v, plain).transpose(1, 2).reshape(n, t, h)
                x = x + F.linear(a, o_w, o_b)
                y = F.layer_norm(x, (h,), f_w, f_b, eps)
                x = x + F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)
            return F.layer_norm(x, (h,), ln_w, ln_b, eps)


def _refresh_after_load(module: SpeechEncoder, incompatible_keys) -> None:
    module._refresh()


def _flatten(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for part in tree for t in _flatten(part)]


class SequenceGeneratorHuBERT(SequenceGeneratorCNN):
    """``SpeechEncoder`` -> Linear(hidden -> 256) -> resize to the video
    frames -> [concat clip code] -> UNet1D -> conv decoder -> (B, T, 2, K).
    ``SPEC`` is the encoder's table (``HUBERT_LARGE``); a subclass replaces
    it."""

    SPEC = HUBERT_LARGE
    MEL_INPUT = False

    def __init__(self, num_landmarks: int = 121, code_dim: Optional[int] = None,
                 norm: str = "IN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        nn.Module.__init__(self)
        generator = generator or torch.Generator().manual_seed(0)
        self.num_landmarks, self.code_dim, self.dtype = num_landmarks, code_dim, dtype
        self.audio_encoder = SpeechEncoder(self.SPEC, dtype, generator)
        self.audio_proj = nn.Linear(self.SPEC.hidden_size, AUDIO_CHANNELS)
        with torch.no_grad():
            self.audio_proj.weight.normal_(0.0, 0.02, generator=generator)
            self.audio_proj.bias.zero_()
        self._build_head(AUDIO_CHANNELS, norm, leaky, generator)

    @classmethod
    def from_cfg(cls, cfg, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> "SequenceGeneratorHuBERT":
        gcfg = cfg.VOICE2POSE.GENERATOR
        return cls(cfg.DATASET.NUM_LANDMARKS, gcfg.CLIP_CODE.DIMENSION, gcfg.NORM,
                   gcfg.LEAKY_RELU, dtype, generator)

    def features(self, audio: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(B, L) waveform -> each clip normalized (``normalize_waveform``)."""
        return normalize_waveform(audio)

    def forward(self, audio: torch.Tensor, num_frames: int,
                code: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
        """``features``' normalized waveform (B, L); code (B, code_dim) or
        (B, code_dim, T), None for a code-less generator -> normalized poses
        (B, num_frames, 2, K) in the compute dtype. ``plain`` takes the math
        attention and the UNet's and decoder's plain layers on the card (a
        reference); train mode always takes the plain layers."""
        return self.decode(self.audio_encoder(audio, plain), num_frames, code, plain)

    def unet_input(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        """Encoder states (B, T, hidden) -> (B, 256, num_frames): the Linear,
        then the CNN encoder's closing resize, bilinear from (1, T) to (1,
        num_frames) with no antialiasing, which at a height of 1 is the linear
        resize of the time axis."""
        p = self.audio_proj
        x = F.linear(x, p.weight.to(self.dtype), p.bias.to(self.dtype)).transpose(1, 2)
        return interpolate_linear_time(x, num_frames)
