"""Model registry: ``build_model(name, cfg, device)``; each registered class reads
its own config keys in ``from_cfg(cfg, dtype, generator)``."""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device
from .autoencoder import Autoencoder, PoseSeqDecoder, PoseSeqEncoder
from .discriminator import PoseSequenceDiscriminator
from .generator import AudioEncoder, SequenceGeneratorCNN, UNet1D
from .speech_encoder import SequenceGeneratorHuBERT, SequenceGeneratorWavLM, SpeechEncoder

MODELS = {"SequenceGeneratorCNN": SequenceGeneratorCNN,
          "SequenceGeneratorHuBERT": SequenceGeneratorHuBERT,
          "SequenceGeneratorWavLM": SequenceGeneratorWavLM,
          "PoseSequenceDiscriminator": PoseSequenceDiscriminator,
          "PoseSeqEncoder": PoseSeqEncoder,
          "Autoencoder": Autoencoder}

__all__ = ["AudioEncoder", "Autoencoder", "PoseSeqDecoder", "PoseSeqEncoder",
           "PoseSequenceDiscriminator", "SequenceGeneratorCNN", "SequenceGeneratorHuBERT",
           "SequenceGeneratorWavLM", "SpeechEncoder", "UNet1D", "build_model", "compute_dtype"]


def compute_dtype(cfg) -> torch.dtype:
    precision = cfg.TRAIN.PRECISION
    if precision == "bf16":
        return torch.bfloat16
    if precision == "fp32":
        return torch.float32
    raise ValueError(f"TRAIN.PRECISION must be 'fp32' or 'bf16', got {precision!r}")


def build_model(name: str, cfg, device="cuda",
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Construct a registered module in eval mode on ``device``.

    Weights are drawn on the CPU from ``generator`` (default: seeded with 0),
    so the same seed gives the same weights on every device. Raises when
    ``device`` is CUDA and no card is present."""
    device = resolve_device(device)
    if name not in MODELS:
        raise KeyError(f"Unknown model: {name}; available: {sorted(MODELS)}")
    model = MODELS[name].from_cfg(cfg, compute_dtype(cfg), generator)
    return model.eval().to(device)
