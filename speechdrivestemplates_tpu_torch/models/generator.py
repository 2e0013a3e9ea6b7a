"""Audio -> pose-sequence generator at static lengths, eval and train forward.

Counterpart of the JAX package's ``models/generator.py`` (AudioEncoder,
UNet1D, SequenceGeneratorCNN). Submodule names are the reference torch
attributes (``audio_encoder.specgram_encoder_2d.{n//2}.{n%2}``,
``unet.{e0..e6,d1..d5}``, ``decoder.{0..4}``), so reference-layout checkpoints
load with ``strict=True``. Inside, 2D tensors are (B, C, H, W) and 1D tensors
(B, C, T); the public output is the JAX layout (B, T, 2, K).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import stem as stem_ops
from ..ops.mel import mel_spectrogram, mel_spectrogram_plain
from ..ops.resize import interpolate_bilinear, interpolate_linear_time
from ..utils import trace
from .blocks import ConvNormRelu, lecun_conv1d

# (out channels, extra ConvNormRelu arguments) of the audio encoder's 8 layers;
# kernel tuples are (H = mel, W = time)
ENCODER_SPECS = [(64, {}), (64, dict(downsample=True)),
                 (128, {}), (128, dict(downsample=True)),
                 (256, {}), (256, dict(downsample=True)),
                 (256, {}), (256, dict(kernel_size=(6, 3), stride=1, padding=0))]


class AudioEncoder(nn.Module):
    """2D CNN over the mel spectrogram, resampled to the video frame rate.

    An IN encoder runs layers 0-2 as one stem (``ops/stem.py``): the fused
    CUDA kernels in eval mode on the card; the plain layers (cuDNN convs under
    autograd) in train mode, on the CPU, or when ``plain`` is set. The kernels
    have no backward, as the JAX package's Pallas stem has none: it runs only
    at inference there too. A BN encoder (s2g) runs its eight layers in order,
    in every mode and on every device: the stem kernels compute InstanceNorm,
    and the JAX package gives its Pallas stem IN encoders only. Each BN layer
    applies its norm by the bn_act kernel on the same terms (``ConvNormRelu``).
    Off the CPU the BN encoder runs channels-last from its input on, in every
    mode and with ``plain`` too, so that the plain path (a reference) and the
    kernels' route run the same convolutions.
    """

    def __init__(self, norm: str = "IN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers, c_in = [], 1
        for c_out, kw in ENCODER_SPECS:
            layers.append(ConvNormRelu("2d", c_in, c_out, norm=norm, leaky=leaky,
                                       dtype=dtype, generator=generator, **kw))
            c_in = c_out
        self.specgram_encoder_2d = nn.Sequential(
            *[nn.Sequential(layers[i], layers[i + 1]) for i in range(0, 8, 2)])
        self.slope = layers[0].slope
        self.norm = norm
        self.dtype = dtype

    def layers(self) -> list[ConvNormRelu]:
        return [m for pair in self.specgram_encoder_2d for m in pair]

    def forward(self, mel: torch.Tensor, num_frames: int,
                plain: bool = False) -> torch.Tensor:
        """mel (B, 80, T_mel) -> (B, 256, num_frames)."""
        layers = self.layers()
        if self.norm == "BN":
            # (B, 1, 80, T_mel). Off the CPU a channels-last view: cuDNN's bf16
            # engines compute in NHWC, so every conv then reads and writes NHWC
            # and no layer transposes in or out (each layer's output, bn_act's
            # too, keeps its input's layout). The CPU keeps NCHW.
            if mel.device.type == "cpu":
                x = mel[:, None]
            else:
                x = mel.unsqueeze(-1).permute(0, 3, 1, 2)
        else:
            stem = (stem_ops.stem_plain if plain or self.training
                    else stem_ops.audio_encoder_stem)
            with trace.span("encoder.stem"):
                x = stem(mel, *(layers[i].conv.weight for i in range(3)),
                         slope=self.slope, dtype=self.dtype)  # (B, 40, W2, 128)
            x, layers = x.permute(0, 3, 1, 2), layers[3:]
        with trace.span("encoder.layers"):
            for layer in layers:
                x = layer(x, plain)
            # (B, 256, H', W') -> bilinear to (1, num_frames), no antialiasing
            return interpolate_bilinear(x, (1, num_frames))[:, :, 0, :]


class UNet1D(nn.Module):
    """Temporal 1D UNet with additive skips after linear upsampling (T >= 32)."""

    def __init__(self, in_channels: int, norm: str = "IN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def cnr(c_in, down=False):
            return ConvNormRelu("1d", c_in, 256, downsample=down, norm=norm,
                                leaky=leaky, dtype=dtype, generator=generator)

        self.e0, self.e1 = cnr(in_channels), cnr(256)
        self.e2, self.e3, self.e4, self.e5, self.e6 = (cnr(256, True) for _ in range(5))
        self.d5, self.d4, self.d3, self.d2, self.d1 = (cnr(256) for _ in range(5))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        e0 = self.e0(x, plain)
        e1 = self.e1(e0, plain)
        e2 = self.e2(e1, plain)
        e3 = self.e3(e2, plain)
        e4 = self.e4(e3, plain)
        e5 = self.e5(e4, plain)
        e6 = self.e6(e5, plain)

        def up(a, b):
            return interpolate_linear_time(a, b.shape[-1]) + b

        d5 = self.d5(up(e6, e5), plain)
        d4 = self.d4(up(d5, e4), plain)
        d3 = self.d3(up(d4, e3), plain)
        d2 = self.d2(up(d3, e2), plain)
        return self.d1(up(d2, e1), plain)


class SequenceGeneratorCNN(nn.Module):
    """AudioEncoder -> [concat clip code] -> UNet1D -> conv decoder -> (B, T, 2, K).
    ``MEL_INPUT``: ``features`` is the mel, which the sequence-parallel demo
    splits and the serving export covers."""

    MEL_INPUT = True

    def __init__(self, num_landmarks: int = 121, code_dim: Optional[int] = None,
                 norm: str = "IN", leaky: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.num_landmarks = num_landmarks
        self.code_dim = code_dim
        self.dtype = dtype
        self.audio_encoder = AudioEncoder(norm, leaky, dtype, generator)
        self._build_head(256, norm, leaky, generator)

    def _build_head(self, audio_channels: int, norm: str, leaky: bool,
                    generator: torch.Generator) -> None:
        """The UNet over the audio's channels and the code's, and the decoder."""
        self.unet = UNet1D(audio_channels + (self.code_dim or 0), norm, leaky, self.dtype,
                           generator)
        out = lecun_conv1d(256, 2 * self.num_landmarks, generator)
        self.decoder = nn.Sequential(
            *[ConvNormRelu("1d", 256, 256, norm=norm, leaky=leaky, dtype=self.dtype,
                           generator=generator) for _ in range(4)], out)

    @classmethod
    def from_cfg(cls, cfg, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> "SequenceGeneratorCNN":
        gcfg = cfg.VOICE2POSE.GENERATOR
        return cls(cfg.DATASET.NUM_LANDMARKS, gcfg.CLIP_CODE.DIMENSION, gcfg.NORM,
                   gcfg.LEAKY_RELU, dtype, generator)

    def features(self, audio: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """What the generator takes of a (B, L) waveform: its mel spectrogram
        (the kernel on the card, the plain version on the CPU or with
        ``plain``)."""
        return (mel_spectrogram_plain if plain else mel_spectrogram)(audio)

    def forward(self, mel: torch.Tensor, num_frames: int,
                code: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
        """mel (B, 80, T_mel); code (B, code_dim) or (B, code_dim, T), None
        for a code-less generator -> normalized poses (B, num_frames, 2, K) in
        the compute dtype. ``plain`` runs the plain layers even on the card in
        eval mode, an IN stem's and every BN layer's (a reference); train mode
        always does."""
        return self.decode(self.audio_encoder(mel, num_frames, plain), num_frames, code, plain)

    def unet_input(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        """The audio encoder's output as the UNet takes it, (B, 256, num_frames)."""
        return x

    def decode(self, x: torch.Tensor, num_frames: int, code: Optional[torch.Tensor],
               plain: bool = False) -> torch.Tensor:
        """The audio encoder's output -> ``unet_input`` -> [concat code] ->
        UNet1D -> decoder -> (B, num_frames, 2, K)."""
        with trace.span("unet"):
            x = self.unet_input(x, num_frames)  # (B, 256, T)
            if self.code_dim is not None:
                if code is None:
                    raise ValueError("this generator takes a clip code")
                if code.ndim == 2:
                    code = code[:, :, None].expand(-1, -1, x.shape[-1])
                x = torch.cat([x, code.to(x.dtype)], dim=1)
            x = self.unet(x, plain)
        with trace.span("decoder"):
            for layer in self.decoder[:4]:
                x = layer(x, plain)
            out = self.decoder[4]
            x = F.conv1d(x, out.weight.to(self.dtype), out.bias.to(self.dtype))
            # (B, 2K, T) -> (B, T, 2K) -> (B, T, 2, K): channel = coord * K + k
            return x.transpose(1, 2).reshape(x.shape[0], num_frames, 2,
                                             self.num_landmarks)
