"""HuBERT's speech encoder (Hsu et al., HuBERT, IEEE/ACM TASLP 2021;
``facebook/hubert-large-ll60k``'s ``config.json``, transformers'
``HubertModel`` with ``feat_extract_norm="layer"``,
``do_stable_layer_norm=True``, ``conv_bias=True``) and the SDT generator that
takes its features, as plain float32 functions of a parameter dict keyed by
the port's names (the encoder's under ``audio_encoder.``, as ``HubertModel``'s
state dict names them, the positional convolution's ``weight_g`` and
``weight_v`` as the public checkpoint does).

The encoder: each clip normalized to zero mean and unit variance (eps 1e-7,
HuBERT's feature extractor); seven ``Conv1d`` with bias, each followed by a
LayerNorm over its channels and exact GELU; LayerNorm, then the projection
to the hidden size; the positional convolution (grouped, weight norm over
dim 2, padded by half its kernel, the last frame dropped for an even kernel,
GELU) added; pre-LN layers ``x += O(Attn(LN(x)))`` and ``x += W2 GELU(W1
LN(x))``; the final LayerNorm. Attention is written out: softmax(Q K^T /
sqrt(head_dim)) V per head, full and bidirectional. The glue (this
repository's choice): Linear(hidden -> 256), the bilinear resize of (1, T)
to (1, num_frames) with no antialiasing, then SDT-BP's code concat, UNet and
decoder through ``generator.py``'s layer function.

``quant``, where given, is applied to every convolution's and matmul's
operands and output (the attention's two products included).
"""

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from . import generator as ref_gen

NORMALIZE_EPS = 1e-7


def _enc(name: str) -> str:
    return f"audio_encoder.{name}"


def leaves(m: dict) -> List[tuple]:
    """(name, shape, kind) of every parameter: the encoder's, the glue's, then
    SDT's UNet and decoder (``generator.leaves`` without its audio encoder).
    Kinds: 'conv', 'hubert_linear', 'hubert_bias', 'ln_weight', 'ln_bias',
    'pos_conv_v', 'pos_conv_g', and the generator's 'out_weight', 'out_bias'."""
    h, c_in, out = m["hidden_size"], 1, []

    def ln(name, c):
        out.extend([(f"{name}.weight", (c,), "ln_weight"), (f"{name}.bias", (c,), "ln_bias")])

    def linear(name, c_out, c_in):
        out.extend([(f"{name}.weight", (c_out, c_in), "hubert_linear"),
                    (f"{name}.bias", (c_out,), "hubert_bias")])

    for i, (c, k) in enumerate(zip(m["conv_dim"], m["conv_kernel"])):
        name = _enc(f"feature_extractor.conv_layers.{i}")
        out.extend([(f"{name}.conv.weight", (c, c_in, k), "conv"),
                    (f"{name}.conv.bias", (c,), "hubert_bias")])
        ln(f"{name}.layer_norm", c)
        c_in = c
    ln(_enc("feature_projection.layer_norm"), c_in)
    linear(_enc("feature_projection.projection"), h, c_in)
    k, g = m["num_conv_pos_embeddings"], m["num_conv_pos_embedding_groups"]
    pos = _enc("encoder.pos_conv_embed.conv")
    out.extend([(f"{pos}.weight_v", (h, h // g, k), "pos_conv_v"),
                (f"{pos}.weight_g", (1, 1, k), "pos_conv_g"),
                (f"{pos}.bias", (h,), "hubert_bias")])
    for i in range(m["num_hidden_layers"]):
        layer = _enc(f"encoder.layers.{i}")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{layer}.attention.{p}", h, h)
        ln(f"{layer}.layer_norm", h)
        linear(f"{layer}.feed_forward.intermediate_dense", m["intermediate_size"], h)
        linear(f"{layer}.feed_forward.output_dense", h, m["intermediate_size"])
        ln(f"{layer}.final_layer_norm", h)
    ln(_enc("encoder.layer_norm"), h)
    linear("audio_proj", 256, h)
    return out + [x for x in ref_gen.leaves(m["code_dim"], m["norm"], m["num_landmarks"])
                  if not x[0].startswith("audio_encoder.")]


def normalize(audio: torch.Tensor) -> torch.Tensor:
    x = audio.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + NORMALIZE_EPS)


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _linear(x, p, name, q):
    return q(q(x) @ q(p[f"{name}.weight"]).T + p[f"{name}.bias"])


def encoder(p: Dict[str, torch.Tensor], audio: torch.Tensor, m: dict,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """(B, L) raw audio -> the final LayerNorm's (B, T, hidden), float32."""
    q = quant or (lambda t: t)
    eps, h, heads = m["layer_norm_eps"], m["hidden_size"], m["num_attention_heads"]
    x = normalize(audio)[:, None]
    for i, s in enumerate(m["conv_stride"]):
        name = _enc(f"feature_extractor.conv_layers.{i}")
        y = q(F.conv1d(q(x), q(p[f"{name}.conv.weight"]), p[f"{name}.conv.bias"], stride=s))
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
    for i in range(m["num_hidden_layers"]):
        layer = _enc(f"encoder.layers.{i}")
        y = _ln(x, p, f"{layer}.layer_norm", eps)
        qh, kh, vh = (_linear(y, p, f"{layer}.attention.{s}_proj", q)
                      .view(n, t, heads, d).transpose(1, 2) for s in "qkv")
        scores = q(q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(d)
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
    (B, num_frames, 2, num_landmarks), float32."""
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
