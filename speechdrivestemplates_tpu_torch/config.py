"""The configuration keys this port reads, as plain dataclasses.

Names and defaults follow the JAX package's yacs tree (``cfg.VOICE2POSE.
GENERATOR.NORM`` and so on) so a reader finds each key's counterpart; only the
keys the ported slices read exist here. The presets stand for the repository's
``configs/*.yaml`` (the port reads no YAML): ``sdt_bp()`` (the flagship,
``configs/voice2pose_sdt_bp.yaml``), ``sdt_vae()``, ``s2g()`` and
``pose2pose()``, the Voice2Pose ones at ``TRAIN.PRECISION='bf16'``; ``preset_for_config_file`` picks
one by the file's name. ``apply_overrides`` merges a flat ``KEY VALUE`` list as
yacs' ``merge_from_list`` does.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Optional


@dataclass
class ClipCodeConfig:
    DIMENSION: Optional[int] = None
    LR_SCALING: float = 1.0
    FRAME_VARIANT: bool = False
    SAMPLE_FROM_NORMAL: bool = False
    TEST_WITH_GT_CODE: bool = False
    EXTERNAL_CODE: bool = False
    EXTERNAL_CODE_PTH: Optional[str] = None


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
    AE_CHECKPOINT: Optional[str] = None  # a Pose2Pose .pth: the frozen encoder's weights


@dataclass
class PoseDiscriminatorConfig:
    NAME: Optional[str] = None
    LEAKY_RELU: bool = False
    LAMBDA_GAN: float = 1.0
    MOTION: bool = True  # score frame-to-frame differences, not poses
    WHITE_LIST: Optional[list] = None  # keypoint indices the discriminator sees


@dataclass
class Voice2PoseConfig:
    GENERATOR: GeneratorConfig = field(default_factory=GeneratorConfig)
    POSE_ENCODER: PoseEncoderConfig = field(default_factory=PoseEncoderConfig)
    POSE_DISCRIMINATOR: PoseDiscriminatorConfig = field(
        default_factory=PoseDiscriminatorConfig)


@dataclass
class AutoencoderConfig:
    NAME: Optional[str] = None
    LEAKY_RELU: bool = True
    NORM: str = "BN"
    CODE_DIM: int = 32


@dataclass
class Pose2PoseConfig:
    AUTOENCODER: AutoencoderConfig = field(default_factory=AutoencoderConfig)
    LAMBDA_REG: float = 1.0
    LAMBDA_KL: float = 0.1


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
    MAX_DEMO_LENGTH: Optional[int] = 24  # seconds: a longer demo wav is cropped (seeded)
    CACHING: bool = False  # the split read once into SoA arrays, batches gathered from them
    DEVICE_CACHE: str = "auto"  # 'auto' | 'on' (raise when it cannot engage) | 'off'
    DEVICE_CACHE_MAX_MB: int = 2048  # the train set staged on the card up to this size


@dataclass
class TrainConfig:
    NUM_EPOCHS: int = 100
    BATCH_SIZE: int = 32
    SAVE_VIDEO: bool = True
    SAVE_NPZ: bool = False
    LR: float = 1e-4
    WD: float = 0.0  # yacs' default is the int 0, which refuses `TRAIN.WD 1e-3`
    LR_SCHEDULER: bool = True
    PRETRAIN_FROM: Optional[str] = None  # a .pth whose weights start the run
    AUTO_RESUME: bool = False  # continue this tag's newest loadable checkpoint
    CHECKPOINT_ON_PREEMPT: bool = True  # SIGTERM: checkpoint after the step, exit 143
    VALIDATE: bool = True
    NUM_RESULT_SAMPLE: int = 2  # result archives an epoch (TRAIN.SAVE_NPZ)
    CHECKPOINT_INTERVAL: int = 1  # epochs between checkpoint saves
    PRECISION: str = "fp32"  # 'fp32' | 'bf16': compute dtype of the conv stacks
    STEPS_PER_DISPATCH: int = 1  # K > 1: K steps in one CUDA graph (needs the device cache)


@dataclass
class TestConfig:
    BATCH_SIZE: int = 32
    NUM_RESULT_SAMPLE: int = 8  # result archives per evaluation (TEST.SAVE_NPZ)
    SAVE_VIDEO: bool = True
    SAVE_NPZ: bool = True
    MULTIPLE: int = 1  # each eval batch repeated this many times


@dataclass
class DemoConfig:
    MULTIPLE: int = 1  # passes over each clip, the code moved from row A towards row B
    NUM_SAMPLES: int = 1  # wavs sampled from a --demo_input directory
    CODE_INDEX: Optional[int] = None  # a fixed bank row as every eval code
    CODE_INDEX_B: Optional[int] = None  # the row it is interpolated towards
    CODE_PATH: Optional[str] = None  # Pose2Pose: an npz whose "v" rows are decoded
    WINDOWED: bool = False  # a clip longer than WINDOW_FRAMES runs as crossfaded windows
    WINDOW_FRAMES: int = 64
    HALO_FRAMES: int = 16  # overlap cropped and crossfaded on each side of a window
    SEQUENCE_PARALLEL: bool = False  # not ported: ROADMAP.md queue A, item 14
    LENGTH_BUCKET_S: float = 2.0  # read for the JAX YAMLs and ignored: clips run at their length


@dataclass
class ProfileConfig:
    ENABLED: bool = False
    START_STEP: int = 10  # global step where the torch.profiler window opens
    NUM_STEPS: int = 5
    OUT_DIR: Optional[str] = None  # default: <run>/profile


@dataclass
class SysConfig:
    OUTPUT_DIR: str = "output/"
    LOG_INTERVAL: int = 100  # steps between log lines
    SEED: int = 0
    NUM_WORKERS: int = 8  # loader worker processes (0: load in the training process)
    PROFILE: ProfileConfig = field(default_factory=ProfileConfig)


@dataclass
class Config:
    PIPELINE_TYPE: Optional[str] = None  # 'Voice2Pose' | 'Pose2Pose'
    VOICE2POSE: Voice2PoseConfig = field(default_factory=Voice2PoseConfig)
    POSE2POSE: Pose2PoseConfig = field(default_factory=Pose2PoseConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    DEMO: DemoConfig = field(default_factory=DemoConfig)
    SYS: SysConfig = field(default_factory=SysConfig)


def _voice2pose(speaker: Optional[str], precision: str, external_code: bool) -> Config:
    cfg = Config()
    cfg.PIPELINE_TYPE = "Voice2Pose"
    cfg.VOICE2POSE.GENERATOR.NAME = "SequenceGeneratorCNN"
    cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION = 32
    cfg.VOICE2POSE.GENERATOR.CLIP_CODE.EXTERNAL_CODE = external_code
    cfg.DATASET.SPEAKER = speaker
    cfg.TRAIN.PRECISION = precision
    return cfg


def sdt_bp(speaker: Optional[str] = "oliver", precision: str = "bf16") -> Config:
    """SDT-BP: SequenceGeneratorCNN with a learned bank of 32-d clip codes, IN,
    leaky ReLU (``configs/voice2pose_sdt_bp.yaml``)."""
    return _voice2pose(speaker, precision, external_code=False)


def sdt_vae(speaker: Optional[str] = "oliver", precision: str = "bf16") -> Config:
    """SDT-VAE: SDT-BP's generator on a frozen bank, a Pose2Pose checkpoint's
    ``clip_code_mu`` (``configs/voice2pose_sdt_vae.yaml``)."""
    return _voice2pose(speaker, precision, external_code=True)


def s2g(speaker: Optional[str] = "oliver", precision: str = "bf16") -> Config:
    """s2g-GAN, the paper's baseline (``configs/voice2pose_s2g.yaml``): a
    code-less BN generator trained against the LSGAN
    ``PoseSequenceDiscriminator`` (LAMBDA_GAN 0.1, leaky), on global poses."""
    cfg = _voice2pose(speaker, precision, external_code=False)
    cfg.VOICE2POSE.GENERATOR.NORM = "BN"
    cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION = None
    d = cfg.VOICE2POSE.POSE_DISCRIMINATOR
    d.NAME, d.LAMBDA_GAN, d.LEAKY_RELU = "PoseSequenceDiscriminator", 0.1, True
    cfg.DATASET.HIERARCHICAL_POSE = False
    cfg.SYS.NUM_WORKERS = 16
    return cfg


def pose2pose(speaker: Optional[str] = "oliver", precision: str = "fp32") -> Config:
    """The Pose2Pose VAE (``configs/pose2pose.yaml``): its encoder is the FGD
    feature encoder, its ``clip_code_mu`` bank SDT-VAE's templates."""
    cfg = Config()
    cfg.PIPELINE_TYPE = "Pose2Pose"
    cfg.POSE2POSE.AUTOENCODER.NAME = "Autoencoder"
    cfg.DATASET.SPEAKER = speaker
    cfg.TRAIN.PRECISION = precision
    return cfg


PRESETS = {"voice2pose_sdt_bp": sdt_bp, "voice2pose_sdt_vae": sdt_vae,
           "voice2pose_s2g": s2g, "pose2pose": pose2pose}


def preset_for_config_file(path: str) -> Config:
    """The preset named like ``configs/<name>.yaml`` (the file is not read)."""
    name = os.path.splitext(os.path.basename(path))[0]
    if name not in PRESETS:
        raise ValueError(f"no preset for config file {path!r}; the port has "
                         f"{sorted(f'configs/{n}.yaml' for n in PRESETS)}")
    return PRESETS[name]()


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
