"""``SequenceGeneratorCNN``: the audio encoder (eight 2-D conv-norm-leaky-ReLU
layers over the mel, resized to the video frames), the clip code concatenated
along channels, the 1-D UNet with additive skips, and the conv decoder, as
plain functions of a parameter dict keyed by the reference repository's names.

Norms: IN on 2-D tensors normalizes each (sample, channel) over (H, W); IN on
1-D tensors normalizes each (sample, time) over the channels (the reference
permutes before ``InstanceNorm1d``); biased variance, eps 1e-5, no affine. BN
(s2g) in eval mode normalizes with the running statistics, then scales and
shifts. Convolutions have no bias except the decoder's last 1x1.

``quant``, where given, is applied to every convolution's input, weight and
output: the control computes the same function in a lower precision that way.
"""

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
# (C_in, C_out, kernel (H, W), stride, padding) of the audio encoder's layers
ENCODER = [(1, 64, (3, 3), 1, 1), (64, 64, (4, 4), 2, 1), (64, 128, (3, 3), 1, 1),
           (128, 128, (4, 4), 2, 1), (128, 256, (3, 3), 1, 1), (256, 256, (4, 4), 2, 1),
           (256, 256, (3, 3), 1, 1), (256, 256, (6, 3), 1, 0)]
UNET_DOWN = ["e2", "e3", "e4", "e5", "e6"]
UNET_UP = ["d5", "d4", "d3", "d2", "d1"]


def encoder_name(i: int) -> str:
    return f"audio_encoder.specgram_encoder_2d.{i // 2}.{i % 2}"


def conv_layers(code_dim: Optional[int]) -> List[Tuple[str, tuple]]:
    """Every conv-norm layer as (name, weight shape), in forward order."""
    out = [(encoder_name(i), (co, ci, *k)) for i, (ci, co, k, _, _) in enumerate(ENCODER)]
    out.append(("unet.e0", (256, 256 + (code_dim or 0), 3)))
    out.append(("unet.e1", (256, 256, 3)))
    out += [(f"unet.{n}", (256, 256, 4)) for n in UNET_DOWN]
    out += [(f"unet.{n}", (256, 256, 3)) for n in UNET_UP]
    out += [(f"decoder.{i}", (256, 256, 3)) for i in range(4)]
    return out


def leaves(code_dim: Optional[int], norm: str, num_landmarks: int) -> List[tuple]:
    """(name, shape, kind) of every parameter and buffer; kind is 'conv',
    'out_weight', 'out_bias', 'bn_weight', 'bn_bias', 'bn_mean', 'bn_var'."""
    out = []
    for name, shape in conv_layers(code_dim):
        out.append((f"{name}.conv.weight", shape, "conv"))
        if norm == "BN":
            c = shape[0]
            out += [(f"{name}.norm.weight", (c,), "bn_weight"), (f"{name}.norm.bias", (c,), "bn_bias"),
                    (f"{name}.norm.running_mean", (c,), "bn_mean"),
                    (f"{name}.norm.running_var", (c,), "bn_var")]
    out.append(("decoder.4.weight", (2 * num_landmarks, 256, 1), "out_weight"))
    out.append(("decoder.4.bias", (2 * num_landmarks,), "out_bias"))
    return out


def _norm_act(y: torch.Tensor, p: Dict[str, torch.Tensor], name: str, norm: str,
              slope: float) -> torch.Tensor:
    if norm == "IN":
        dims = (-2, -1) if y.ndim == 4 else (1,)
        var, mean = torch.var_mean(y, dim=dims, correction=0, keepdim=True)
        y = (y - mean) * torch.rsqrt(var + EPS)
    else:
        shape = (1, -1) + (1,) * (y.ndim - 2)
        mean, var = p[f"{name}.norm.running_mean"], p[f"{name}.norm.running_var"]
        y = (y - mean.view(shape)) * torch.rsqrt(var.view(shape) + EPS)
        y = y * p[f"{name}.norm.weight"].view(shape) + p[f"{name}.norm.bias"].view(shape)
    return F.leaky_relu(y, slope)


def _cnr(x, p, name, stride, padding, norm, slope, quant):
    w = p[f"{name}.conv.weight"]
    conv = F.conv2d if w.ndim == 4 else F.conv1d
    return _norm_act(quant(conv(quant(x), quant(w), stride=stride, padding=padding)), p,
                     name, norm, slope)


def forward(p: Dict[str, torch.Tensor], mel: torch.Tensor, num_frames: int,
            code: Optional[torch.Tensor], norm: str, slope: float, num_landmarks: int,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """mel (B, 80, T_mel), code (B, code_dim) or None -> normalized poses
    (B, num_frames, 2, num_landmarks), float32."""
    q = quant or (lambda t: t)
    x = mel[:, None].float()
    for i, (_, _, _, stride, padding) in enumerate(ENCODER):
        x = _cnr(x, p, encoder_name(i), stride, padding, norm, slope, q)
    x = F.interpolate(x, size=(1, num_frames), mode="bilinear", align_corners=False)[:, :, 0]
    if code is not None:
        x = torch.cat([x, code.float()[:, :, None].expand(-1, -1, num_frames)], dim=1)
    skips = []
    for name in ("e0", "e1"):
        x = _cnr(x, p, f"unet.{name}", 1, 1, norm, slope, q)
    skips.append(x)
    for name in UNET_DOWN:
        x = _cnr(x, p, f"unet.{name}", 2, 1, norm, slope, q)
        skips.append(x)
    skips.pop()  # e6 is the bottom, not a skip
    for name in UNET_UP:
        skip = skips.pop()
        x = F.interpolate(x, size=skip.shape[-1], mode="linear", align_corners=False) + skip
        x = _cnr(x, p, f"unet.{name}", 1, 1, norm, slope, q)
    for i in range(4):
        x = _cnr(x, p, f"decoder.{i}", 1, 1, norm, slope, q)
    x = F.conv1d(q(x), q(p["decoder.4.weight"]), p["decoder.4.bias"])
    return x.transpose(1, 2).reshape(x.shape[0], num_frames, 2, num_landmarks)
