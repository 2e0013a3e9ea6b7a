"""WavLM's speech encoder (Chen et al., WavLM, IEEE JSTSP 2022;
``microsoft/wavlm-large``'s ``config.json``, transformers' ``WavLMModel`` with
``feat_extract_norm="layer"``, ``do_stable_layer_norm=True``,
``conv_bias=False``) and the SDT generator that takes its features, as plain
float32 functions of a parameter dict keyed by the port's names (the
encoder's under ``audio_encoder.``, as ``WavLMModel``'s state dict names
them).

The encoder is HuBERT's (``speech_encoder.py``: the normalization, the conv
stack, the projection, the positional convolution, pre-LN layers, the final
LayerNorm) with two differences: the seven convolutions have no bias where
``conv_bias`` is false, and every layer's attention adds a gated
relative-position bias to its scaled scores, written out here:

- bucket of the offset r = j - i (key - query), with n = num_buckets / 2 and
  e = n / 2: ``n [r > 0] + (|r| if |r| < e else min(n - 1, floor(e + ln(|r| /
  e) / ln(max_bucket_distance / e) (n - e))))``, in float32 as transformers
  computes it;
- the table ``P[h, i, j] = E[bucket(j - i), h]``, ``E`` layer 0's
  ``rel_attn_embed`` (num_buckets, heads), shared by every layer;
- each layer's gate from its attention input ``a`` (after the LayerNorm):
  ``gru_rel_pos_linear`` (Linear(head_dim -> 8)) of each head's slice, the 8
  outputs summed in two groups of four, each through a sigmoid, ``g = g_a
  (g_b c_h - 1) + 2`` with ``c = gru_rel_pos_const`` (1, heads, 1, 1);
- ``softmax(Q K^T / sqrt(head_dim) + g[b, h, i] P[h, i, j]) V``.

The glue and SDT's head are ``speech_encoder.py``'s: Linear(hidden -> 256),
the bilinear resize to the video frames, the code concat, the UNet and the
decoder. ``quant``, where given, is applied to every convolution's and
matmul's operands and output (the attention's two products and the gate's
linear included).
"""

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from . import generator as ref_gen
from . import speech_encoder as ref_se
from .speech_encoder import _enc, _linear, _ln


def leaves(m: dict) -> List[tuple]:
    """(name, shape, kind) of every parameter: ``speech_encoder.leaves``
    without the convolutions' biases where ``conv_bias`` is false, then the
    bucket embedding ('rel_embed') and each layer's gate ('gate_linear',
    'hubert_bias', 'gate_const')."""
    out = [x for x in ref_se.leaves(m) if m["conv_bias"] or not (
        x[0].startswith(_enc("feature_extractor.")) and x[0].endswith(".conv.bias"))]
    heads = m["num_attention_heads"]
    out.append((_enc("encoder.layers.0.attention.rel_attn_embed.weight"),
                (m["num_buckets"], heads), "rel_embed"))
    for i in range(m["num_hidden_layers"]):
        a = _enc(f"encoder.layers.{i}.attention")
        out.extend([(f"{a}.gru_rel_pos_linear.weight", (8, m["hidden_size"] // heads),
                     "gate_linear"),
                    (f"{a}.gru_rel_pos_linear.bias", (8,), "hubert_bias"),
                    (f"{a}.gru_rel_pos_const", (1, heads, 1, 1), "gate_const")])
    return out


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of each offset of the integer tensor ``rel``."""
    n = num_buckets // 2
    e = n // 2
    out = (rel > 0).long() * n
    far = rel.abs()
    large = e + torch.log(far.float() / e) / math.log(max_distance / e) * (n - e)
    large = torch.minimum(large.long(), torch.full_like(far, n - 1))
    return out + torch.where(far < e, far, large)


def position_table(p: Dict[str, torch.Tensor], t: int, m: dict) -> torch.Tensor:
    """(heads, t, t): ``P[h, i, j] = E[bucket(j - i), h]``."""
    pos = torch.arange(t, device=p[_enc("encoder.layers.0.attention.rel_attn_embed.weight")]
                       .device)
    idx = bucket(pos[None, :] - pos[:, None], m["num_buckets"], m["max_bucket_distance"])
    return p[_enc("encoder.layers.0.attention.rel_attn_embed.weight")][idx].permute(2, 0, 1)


def encoder(p: Dict[str, torch.Tensor], audio: torch.Tensor, m: dict,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """(B, L) raw audio -> the final LayerNorm's (B, T, hidden), float32."""
    q = quant or (lambda t: t)
    eps, h, heads = m["layer_norm_eps"], m["hidden_size"], m["num_attention_heads"]
    x = ref_se.normalize(audio)[:, None]
    for i, s in enumerate(m["conv_stride"]):
        name = _enc(f"feature_extractor.conv_layers.{i}")
        y = q(F.conv1d(q(x), q(p[f"{name}.conv.weight"]), p.get(f"{name}.conv.bias"), stride=s))
        x = F.gelu(_ln(y.transpose(1, 2), p, f"{name}.layer_norm", eps)).transpose(1, 2)
    x = _ln(x.transpose(1, 2), p, _enc("feature_projection.layer_norm"), eps)
    x = _linear(x, p, _enc("feature_projection.projection"), q)
    pos = _enc("encoder.pos_conv_embed.conv")
    v, g = p[f"{pos}.weight_v"], p[f"{pos}.weight_g"]
    w = g * v / v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    k = w.shape[-1]
    y = q(F.conv1d(q(x.transpose(1, 2)), q(w), p[f"{pos}.bias"], padding=k // 2,
                   groups=m["num_conv_pos_embedding_groups"]))
    if k % 2 == 0:
        y = y[..., :-1]
    x = x + F.gelu(y).transpose(1, 2)
    n, t = x.shape[:2]
    d = h // heads
    table = position_table(p, t, m)
    for i in range(m["num_hidden_layers"]):
        layer = _enc(f"encoder.layers.{i}")
        y = _ln(x, p, f"{layer}.layer_norm", eps)
        qh, kh, vh = (_linear(y, p, f"{layer}.attention.{s}_proj", q)
                      .view(n, t, heads, d).transpose(1, 2) for s in "qkv")
        gate = _linear(y.view(n, t, heads, d), p, f"{layer}.attention.gru_rel_pos_linear", q)
        g_a, g_b = torch.sigmoid(gate.view(n, t, heads, 2, 4).sum(-1)).unbind(-1)
        c = p[f"{layer}.attention.gru_rel_pos_const"].view(heads)
        gate = (g_a * (g_b * c - 1.0) + 2.0).transpose(1, 2)  # (B, heads, T)
        scores = q(q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(d) + gate[..., None] * table
        a = q(q(torch.softmax(scores, dim=-1)) @ q(vh)).transpose(1, 2).reshape(n, t, h)
        x = x + _linear(a, p, f"{layer}.attention.out_proj", q)
        y = _ln(x, p, f"{layer}.final_layer_norm", eps)
        y = F.gelu(_linear(y, p, f"{layer}.feed_forward.intermediate_dense", q))
        x = x + _linear(y, p, f"{layer}.feed_forward.output_dense", q)
    return _ln(x, p, _enc("encoder.layer_norm"), eps)


def forward(p: Dict[str, torch.Tensor], audio: torch.Tensor, num_frames: int,
            code: Optional[torch.Tensor], m: dict,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """(B, L) raw audio, code (B, code_dim) or None -> normalized poses
    (B, num_frames, 2, num_landmarks), float32: ``speech_encoder.forward``
    with this encoder."""
    q = quant or (lambda t: t)
    x = _linear(encoder(p, audio, m, quant), p, "audio_proj", q).transpose(1, 2)
    x = F.interpolate(x[:, :, None], size=(1, num_frames), mode="bilinear",
                      align_corners=False)[:, :, 0]
    if code is not None:
        x = torch.cat([x, code.float()[:, :, None].expand(-1, -1, num_frames)], dim=1)
    norm, slope = m["norm"], m["leaky_slope"]

    def cnr(x, name, stride):
        return ref_gen._cnr(x, p, name, stride, 1, norm, slope, q)

    x = cnr(cnr(x, "unet.e0", 1), "unet.e1", 1)
    skips = [x]
    for name in ref_gen.UNET_DOWN:
        x = cnr(x, f"unet.{name}", 2)
        skips.append(x)
    skips.pop()  # e6 is the bottom, not a skip
    for name in ref_gen.UNET_UP:
        skip = skips.pop()
        x = F.interpolate(x, size=skip.shape[-1], mode="linear", align_corners=False) + skip
        x = cnr(x, f"unet.{name}", 1)
    for i in range(4):
        x = cnr(x, f"decoder.{i}", 1)
    x = F.conv1d(q(x), q(p["decoder.4.weight"]), p["decoder.4.bias"])
    return x.transpose(1, 2).reshape(x.shape[0], num_frames, 2, m["num_landmarks"])
