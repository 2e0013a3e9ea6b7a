"""The configuration keys this port reads, as plain dataclasses.

Names follow the JAX package's yacs tree (``cfg.VOICE2POSE.GENERATOR.NORM``
and so on) so a reader finds each key's counterpart; only the keys the
serving slice reads exist here. ``sdt_bp()`` is the flagship preset
(``configs/voice2pose_sdt_bp.yaml`` with ``TRAIN.PRECISION='bf16'``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ClipCodeConfig:
    DIMENSION: Optional[int] = None


@dataclass
class GeneratorConfig:
    NAME: Optional[str] = None
    LEAKY_RELU: bool = True
    NORM: str = "IN"
    CLIP_CODE: ClipCodeConfig = field(default_factory=ClipCodeConfig)


@dataclass
class Voice2PoseConfig:
    GENERATOR: GeneratorConfig = field(default_factory=GeneratorConfig)


@dataclass
class DatasetConfig:
    NUM_LANDMARKS: int = 121
    HIERARCHICAL_POSE: bool = True
    SPEAKER: Optional[str] = None
    NUM_FRAMES: int = 64
    AUDIO_LENGTH: int = 68267


@dataclass
class TrainConfig:
    PRECISION: str = "fp32"  # 'fp32' | 'bf16': compute dtype of the conv stacks


@dataclass
class Config:
    VOICE2POSE: Voice2PoseConfig = field(default_factory=Voice2PoseConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)


def sdt_bp(speaker: str = "oliver", precision: str = "bf16") -> Config:
    """SDT-BP: SequenceGeneratorCNN with a 32-d clip code, IN, leaky ReLU."""
    cfg = Config()
    cfg.VOICE2POSE.GENERATOR.NAME = "SequenceGeneratorCNN"
    cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION = 32
    cfg.DATASET.SPEAKER = speaker
    cfg.TRAIN.PRECISION = precision
    return cfg
