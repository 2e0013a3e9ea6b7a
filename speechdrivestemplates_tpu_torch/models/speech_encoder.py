"""Speech-transformer audio encoders (HuBERT Large, WavLM Large) and the SDT
generators that take their features in place of the mel CNN's.

``SpeechEncoder`` is HuBERT's encoder as Hsu et al. publish it (HuBERT,
IEEE/ACM TASLP 2021; ``facebook/hubert-large-ll60k``'s ``config.json``), at the
widths of a ``SpeechEncoderSpec`` table, whose fields are the config's keys:
``HUBERT_LARGE``, and ``WAVLM_LARGE`` (Chen et al., WavLM, IEEE JSTSP 2022;
``microsoft/wavlm-large``'s ``config.json``), the same widths with
convolutions without bias and a gated relative-position bias in every layer's
attention (below):

- feature encoder: seven ``Conv1d`` over the raw waveform (with bias where
  ``conv_bias``), each followed by a LayerNorm over its channels and GELU (on
  the card, in a forward that takes no gradient, the bias, LayerNorm and GELU
  run as one kernel after a convolution without its bias: ``ops/ln_gelu.py``,
  handed a zero bias where the table has none);
- feature projection: LayerNorm, then Linear to the hidden size;
- positional convolution: a grouped ``Conv1d`` under weight norm (``dim=2``),
  "same" padded (an even kernel's last frame dropped), GELU, added to its
  input; computed as a product of spectra in float32 (``pos_conv``): at
  k = 128 in 16 groups cuDNN runs it in a slow legacy kernel;
- pre-LN transformer layers, ``x += Attn(LN(x))`` (full, bidirectional, with
  biases) and ``x += W2 GELU(W1 LN(x))``, then a final LayerNorm.

WavLM's relative-position bias (``num_buckets`` > 0; transformers'
``WavLMAttention``): each key - query offset falls in one of ``num_buckets``
buckets (``relative_position_bucket``), layer 0's ``rel_attn_embed`` (an
embedding of a bucket to a value a head) makes the table ``P[h, i, j]``
once a call (``position_table``), shared by every layer; each layer's gate,
``gru_rel_pos_linear`` (Linear(head_dim -> 8)) of each head's slice of the
attention's input summed in two groups of four, ``g = sigmoid(a) *
(sigmoid(b) * gru_rel_pos_const[h] - 1) + 2``, scales it by query:
``softmax(Q K^T / sqrt(head_dim) + g[b, h, i] P[h, i, j]) V``. The gate's two
sums ride in the Q, K, V matmul as 2 x heads more outputs (its weight folded
and laid block-diagonal). The table and each layer's bias are (.., T, T_pad),
T_pad the next multiple of 16, and attention reads their T-wide view: with
rows aligned so, neither biased SDPA kernel copies the bias into a padded
one. Each layer's bias is written whole (755 MB at WavLM Large's B = 32 x
853 frames in bf16) and read back by the attention kernel.

Submodules and parameters are named after transformers' ``HubertModel`` /
``WavLMModel`` state dict (the public checkpoint's: the positional
convolution's ``weight_g`` and ``weight_v``), without ``masked_spec_embed``,
which only pretraining's masking reads; the generator holds the encoder as
``audio_encoder``.

``SequenceGeneratorHuBERT`` is SDT-BP's generator with this encoder: the
encoder, Linear(hidden -> 256), the resize to the video frames that the CNN
encoder ends with, then the code concat, ``UNet1D`` and the decoder of
``SequenceGeneratorCNN`` (its ``decode``). Its ``features`` hook takes each
clip's waveform to zero mean and unit variance, as HuBERT's feature
extractor does; the mel is not computed. ``SequenceGeneratorWavLM`` is the
same generator at ``WAVLM_LARGE``.

Precision: the weights are float32 parameters; a forward computes in the
compute dtype (bf16 on the card), norms and softmax accumulating in float32
inside torch's kernels. A forward that cannot take a gradient (eval mode
with autograd off: serving, the eval and demo steps) reads the weights from a
cache made once, at load: weight norm folded into the effective weight, the
attention's Q, K and V weights (and WavLM's gate) stacked into one matrix, the
convolutions' weights laid out channels-last, each cast to the compute
dtype. The feature encoder keeps its activations (B, T, C), which its convolutions read as
(B, C, 1, T) channels-last. A load refreshes the cache in place, so a CUDA graph that read
it reads the new weights; a parameter changed otherwise (a train step) is
seen by its version and refreshed at the next such forward. Every other
forward computes the same tensors from the parameters under autograd.

Attention is ``scaled_dot_product_attention`` with its backend fixed by one
rule (``attention_backend``): where the card computes in bf16 or fp16 and
``plain`` is off, flash attention without a bias and ``BIASED_BACKEND``
(cuDNN's attention) with one; else, on the CPU or under ``plain``, the math
backend. The backend is forced, so the card never falls back to math
silently: a shape or bias the forced kernel cannot take raises. Each call
that the host runs (eager, or once at a graph's capture) counts in
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
    conv_bias: bool = True
    num_buckets: int = 0  # 0: no relative-position bias (HuBERT)
    max_bucket_distance: int = 0


HUBERT_LARGE = SpeechEncoderSpec()
WAVLM_LARGE = SpeechEncoderSpec(conv_bias=False, num_buckets=320, max_bucket_distance=800)
# the SDPA backend of a biased attention on the card (flash takes no bias):
# cuDNN's, at WavLM Large's 32 x 16 heads x 853 frames 0.53 ms a layer against
# the memory-efficient kernel's 1.16 (H100)
BIASED_BACKEND = "cudnn"


def normalize_waveform(audio: torch.Tensor) -> torch.Tensor:
    """(B, L) -> each clip at zero mean and unit variance, float32."""
    x = audio.float()
    var, mean = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + NORMALIZE_EPS)


def attention_backend(device_type: str, dtype: torch.dtype, biased: bool,
                      plain: bool) -> str:
    """The module's rule: ``"flash"`` without a bias and ``BIASED_BACKEND``
    with one, on the card in bf16 or fp16 unless ``plain``; else ``"math"``."""
    if device_type != "cuda" or dtype not in (torch.bfloat16, torch.float16) or plain:
        return "math"
    return BIASED_BACKEND if biased else "flash"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, plain: bool = False) -> torch.Tensor:
    """Full bidirectional attention of (B, heads, T, head_dim) tensors through
    SDPA, ``bias`` (B, heads, T, T) added to the scaled scores, its backend by
    the module's rule, counted in ``kernels.ATTENTION``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    name = attention_backend(q.device.type, q.dtype, bias is not None, plain)
    backend = {"flash": SDPBackend.FLASH_ATTENTION, "cudnn": SDPBackend.CUDNN_ATTENTION,
               "math": SDPBackend.MATH}[name]
    with sdpa_kernel(backend):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    kernels.ATTENTION[name] += 1
    return out


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """WavLM's bucket of each key - query offset in ``rel`` (an integer
    tensor), transformers' arithmetic: half the buckets a sign; within one,
    offsets under a quarter of the buckets exact, the rest spaced by the log of
    the offset up to ``max_distance`` and clamped to the half's last."""
    half = num_buckets // 2
    exact = half // 2
    far = rel.abs()
    log = torch.log(far.double() / exact) / math.log(max_distance / exact) * (half - exact)
    large = (exact + log).to(torch.long).clamp(max=half - 1)
    return (rel > 0).to(torch.long) * half + torch.where(far < exact, far, large)


def position_table(embed: torch.Tensor, t: int, num_buckets: int,
                   max_distance: int) -> torch.Tensor:
    """``embed`` (heads, num_buckets) -> ``P[h, i, j] = embed[h, bucket(j -
    i)]`` for i < t, j < T_pad, (heads, t, T_pad), T_pad the next multiple of
    16 (the columns past t are the buckets of those offsets: read by no one)."""
    t_pad = -(-t // 16) * 16
    pos = torch.arange(t_pad, device=embed.device)
    idx = relative_position_bucket(pos[None, :] - pos[:t, None], num_buckets, max_distance)
    return embed.index_select(1, idx.flatten()).view(-1, t, t_pad)


def gated_bias(table: torch.Tensor, logits: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """One layer's bias ``g[b, h, i] P[h, i, j]``, (B, heads, t, T_pad) in the
    table's dtype, from the gate's two sums ``logits`` (B, t, heads, 2) and
    ``gru_rel_pos_const`` ``const`` (heads,); the gate in float32. Each (head,
    query) row of the table times the batch's gates is an outer product: one
    batched matmul of inner size 1 writes them, as a (heads, t, B, T_pad)
    buffer (on the card faster than a broadcast product into (B, heads, t,
    T_pad)); the result is its permuted view."""
    h, t, t_pad = table.shape
    s = torch.sigmoid(logits.float())
    g = (s[..., 0] * (s[..., 1] * const - 1.0) + 2.0).to(table.dtype)  # (B, t, heads)
    out = torch.bmm(g.permute(2, 1, 0).reshape(h * t, -1, 1), table.reshape(h * t, 1, t_pad))
    return out.view(h, t, -1, t_pad).permute(2, 0, 1, 3)


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
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, eps: float,
                 bias: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)


class _FeatureEncoder(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        c_in, layers = 1, []
        for c, k, s in zip(spec.conv_dim, spec.conv_kernel, spec.conv_stride):
            layers.append(_ConvLayer(c_in, c, k, s, spec.layer_norm_eps, spec.conv_bias))
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
    """Q, K, V and the output map; with a relative-position bias, the gate
    (every layer) and the bucket embedding (``embed``: layer 0 alone)."""

    def __init__(self, spec: SpeechEncoderSpec, embed: bool):
        super().__init__()
        h, heads = spec.hidden_size, spec.num_attention_heads
        self.k_proj, self.v_proj, self.q_proj, self.out_proj = (nn.Linear(h, h)
                                                                for _ in range(4))
        if spec.num_buckets:
            self.gru_rel_pos_const = nn.Parameter(torch.empty(1, heads, 1, 1))
            self.gru_rel_pos_linear = nn.Linear(h // heads, 8)
            if embed:
                self.rel_attn_embed = nn.Embedding(spec.num_buckets, heads)


class _FeedForward(nn.Module):
    def __init__(self, h: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(h, inner)
        self.output_dense = nn.Linear(inner, h)


class _Layer(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec, first: bool):
        super().__init__()
        h, eps = spec.hidden_size, spec.layer_norm_eps
        self.attention = _Attention(spec, first)
        self.layer_norm = nn.LayerNorm(h, eps=eps)
        self.feed_forward = _FeedForward(h, spec.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(h, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, spec: SpeechEncoderSpec):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(spec)
        self.layer_norm = nn.LayerNorm(spec.hidden_size, eps=spec.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(spec, i == 0) for i in range(spec.num_hidden_layers))


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
        ``weight_g`` its norm, LayerNorms (1, 0), biases 0; WavLM's bucket
        embedding N(0, 1) (PyTorch's, which transformers leaves) and gate
        constants 1."""
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
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=gen)
            elif isinstance(m, _Attention) and hasattr(m, "gru_rel_pos_const"):
                m.gru_rel_pos_const.fill_(1.0)
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.LayerNorm, _WeightNormConv)) \
                    and m.bias is not None:
                m.bias.zero_()

    def _weights(self) -> tuple:
        """The tensors a forward computes with, from the parameters, in the
        compute dtype but the positional convolution's folded weight and the
        gate constants (float32): (conv layers, projection, positional conv,
        layers, final LN, relative position: None, or the bucket embedding
        (heads, num_buckets) and the gate constants (layers, heads)). A
        convolution without bias gets a zero one, the fused kernel's operand."""
        def c(t):
            return t.to(self.dtype)

        def bias(conv):
            if conv.bias is not None:
                return c(conv.bias)
            return torch.zeros(conv.out_channels, dtype=self.dtype, device=conv.weight.device)

        # each (C_out, C_in, k) weight as (C_out, C_in, 1, k) channels-last
        convs = [(c(m.conv.weight).unsqueeze(2).contiguous(memory_format=torch.channels_last),
                  bias(m.conv), c(m.layer_norm.weight), c(m.layer_norm.bias))
                 for m in self.feature_extractor.conv_layers]
        fp = self.feature_projection
        proj = (c(fp.layer_norm.weight), c(fp.layer_norm.bias), c(fp.projection.weight),
                c(fp.projection.bias))
        pc = self.encoder.pos_conv_embed.conv
        pos = (pc.weight().float(), c(pc.bias))
        layers, rel = [], None
        for m in self.encoder.layers:
            a, f = m.attention, m.feed_forward
            qkv = [a.q_proj, a.k_proj, a.v_proj]
            w, b = [p.weight for p in qkv], [p.bias for p in qkv]
            if self.spec.num_buckets:
                # the gate's 8 outputs summed in two groups of four are a map
                # to 2; each head's slice of the input through it, block-diagonal
                g = a.gru_rel_pos_linear
                heads = self.spec.num_attention_heads
                w.append(torch.block_diag(*[g.weight.view(2, 4, -1).sum(1)] * heads))
                b.append(g.bias.view(2, 4).sum(1).repeat(heads))
            layers.append((c(m.layer_norm.weight), c(m.layer_norm.bias),
                           c(torch.cat(w)), c(torch.cat(b)),
                           c(a.out_proj.weight), c(a.out_proj.bias),
                           c(m.final_layer_norm.weight), c(m.final_layer_norm.bias),
                           c(f.intermediate_dense.weight), c(f.intermediate_dense.bias),
                           c(f.output_dense.weight), c(f.output_dense.bias)))
        if self.spec.num_buckets:
            embed = self.encoder.layers[0].attention.rel_attn_embed.weight
            rel = (c(embed.t()), torch.stack([m.attention.gru_rel_pos_const.view(-1)
                                              for m in self.encoder.layers]).float())
        ln = self.encoder.layer_norm
        return convs, proj, pos, layers, (c(ln.weight), c(ln.bias)), rel

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
        convs, (pln_w, pln_b, proj_w, proj_b), (pos_w, pos_b), layers, (ln_w, ln_b), rel = \
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
                y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w,
                             b if spec.conv_bias and not fused else None, stride=(1, stride))
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
            if rel is not None:
                with trace.span("encoder.position_bias"):
                    table = position_table(rel[0], t, spec.num_buckets, spec.max_bucket_distance)
            for i, (a_w, a_b, qkv_w, qkv_b, o_w, o_b, f_w, f_b, w1, b1, w2, b2) in \
                    enumerate(layers):
                qkv = F.linear(F.layer_norm(x, (h,), a_w, a_b, eps), qkv_w, qkv_b)
                q, k, v = qkv[..., :3 * h].view(n, t, 3, heads, h // heads).permute(2, 0, 3, 1, 4)
                bias = None
                if rel is not None:  # the padded bias's T-wide view
                    logits = qkv[..., 3 * h:].view(n, t, heads, 2)
                    bias = gated_bias(table, logits, rel[1][i])[..., :t]
                a = attention(q, k, v, bias, plain).transpose(1, 2).reshape(n, t, h)
                x = x + F.linear(a, o_w, o_b)
                y = F.layer_norm(x, (h,), f_w, f_b, eps)
                x = x + F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)
            return F.layer_norm(x, (h,), ln_w, ln_b, eps)


def _refresh_after_load(module: SpeechEncoder, incompatible_keys) -> None:
    module._refresh()


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for part in tree for t in _flatten(part)]


class SequenceGeneratorHuBERT(SequenceGeneratorCNN):
    """``SpeechEncoder`` -> Linear(hidden -> 256) -> resize to the video
    frames -> [concat clip code] -> UNet1D -> conv decoder -> (B, T, 2, K).
    ``SPEC`` is the encoder's table (``HUBERT_LARGE``); a subclass replaces
    it (``SequenceGeneratorWavLM``)."""

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


class SequenceGeneratorWavLM(SequenceGeneratorHuBERT):
    """``SequenceGeneratorHuBERT`` with WavLM Large's encoder (``WAVLM_LARGE``):
    convolutions without bias, the gated relative-position bias in every
    layer's attention."""

    SPEC = WAVLM_LARGE
