"""The configuration keys this port reads, as plain dataclasses.

Names and defaults follow the JAX package's yacs tree (``cfg.VOICE2POSE.
GENERATOR.NORM`` and so on) so a reader finds each key's counterpart; only the
keys the ported slices read exist here. ``sdt_bp()`` is the flagship preset
(``configs/voice2pose_sdt_bp.yaml`` with ``TRAIN.PRECISION='bf16'``);
``apply_overrides`` merges a flat ``KEY VALUE`` list as yacs' ``merge_from_list``
does.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Optional


@dataclass
class ClipCodeConfig:
    DIMENSION: Optional[int] = None
    LR_SCALING: float = 1.0
    FRAME_VARIANT: bool = False
    EXTERNAL_CODE: bool = False


@dataclass
class GeneratorConfig:
    NAME: Optional[str] = None
    LEAKY_RELU: bool = True
    NORM: str = "IN"
    LAMBDA_REG: float = 1.0
    LAMBDA_CLIP_KL: float = 0.1
    CLIP_CODE: ClipCodeConfig = field(default_factory=ClipCodeConfig)


@dataclass
class PoseEncoderConfig:
    NAME: Optional[str] = "PoseSeqEncoder"


@dataclass
class PoseDiscriminatorConfig:
    NAME: Optional[str] = None


@dataclass
class Voice2PoseConfig:
    GENERATOR: GeneratorConfig = field(default_factory=GeneratorConfig)
    POSE_ENCODER: PoseEncoderConfig = field(default_factory=PoseEncoderConfig)
    POSE_DISCRIMINATOR: PoseDiscriminatorConfig = field(
        default_factory=PoseDiscriminatorConfig)


@dataclass
class AutoencoderConfig:
    LEAKY_RELU: bool = True
    NORM: str = "BN"
    CODE_DIM: int = 32


@dataclass
class Pose2PoseConfig:
    AUTOENCODER: AutoencoderConfig = field(default_factory=AutoencoderConfig)


@dataclass
class DatasetConfig:
    ROOT_DIR: str = "datasets/speakers"
    SUBSET: Optional[int] = None
    NUM_LANDMARKS: int = 121
    HIERARCHICAL_POSE: bool = True
    SPEAKER: Optional[str] = None
    NUM_FRAMES: int = 64
    AUDIO_LENGTH: int = 68267
    AUDIO_SR: int = 16000
    FPS: int = 15


@dataclass
class TrainConfig:
    NUM_EPOCHS: int = 100
    BATCH_SIZE: int = 32
    SAVE_VIDEO: bool = True
    SAVE_NPZ: bool = False
    LR: float = 1e-4
    WD: float = 0.0  # yacs' default is the int 0, which refuses `TRAIN.WD 1e-3`
    LR_SCHEDULER: bool = True
    VALIDATE: bool = True
    CHECKPOINT_INTERVAL: int = 1  # epochs between checkpoint saves
    PRECISION: str = "fp32"  # 'fp32' | 'bf16': compute dtype of the conv stacks


@dataclass
class SysConfig:
    OUTPUT_DIR: str = "output/"
    LOG_INTERVAL: int = 100  # steps between log lines
    SEED: int = 0
    NUM_WORKERS: int = 8  # loader worker processes (0: load in the training process)


@dataclass
class Config:
    VOICE2POSE: Voice2PoseConfig = field(default_factory=Voice2PoseConfig)
    POSE2POSE: Pose2PoseConfig = field(default_factory=Pose2PoseConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    SYS: SysConfig = field(default_factory=SysConfig)


def sdt_bp(speaker: str = "oliver", precision: str = "bf16") -> Config:
    """SDT-BP: SequenceGeneratorCNN with a 32-d clip code, IN, leaky ReLU."""
    cfg = Config()
    cfg.VOICE2POSE.GENERATOR.NAME = "SequenceGeneratorCNN"
    cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION = 32
    cfg.DATASET.SPEAKER = speaker
    cfg.TRAIN.PRECISION = precision
    return cfg


def _decode(value: str):
    """A command-line value as a Python literal where it parses as one, else
    the string itself (yacs' ``_decode_cfg_value``)."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_overrides(cfg: Config, opts: list) -> Config:
    """Merge ``["KEY", "VALUE", ...]`` into ``cfg`` in place and return it.

    Each value is decoded as a literal and must have the type of the key's
    current value; as in yacs, a key whose value is None takes any type, an
    int is accepted for a float key, and anything else raises."""
    if len(opts) % 2:
        raise ValueError(f"overrides must be KEY VALUE pairs, got {opts}")
    for key, raw in zip(opts[0::2], opts[1::2]):
        *path, leaf = key.split(".")
        node = cfg
        for part in path:
            node = getattr(node, part, None)
            if not is_dataclass(node):
                raise KeyError(f"Non-existent config key: {key}")
        if leaf not in {f.name for f in fields(node)} or is_dataclass(getattr(node, leaf)):
            raise KeyError(f"Non-existent config key: {key}")
        old, new = getattr(node, leaf), _decode(raw)
        if type(new) is not type(old) and old is not None and new is not None:
            if type(new) is int and type(old) is float:
                new = float(new)
            else:
                raise ValueError(f"Type mismatch ({type(old)} vs. {type(new)}) with "
                                 f"values ({old} vs. {new}) for config key: {key}")
        setattr(node, leaf, new)
    return cfg
