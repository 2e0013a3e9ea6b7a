"""The configuration tree, as plain dataclasses, and the config-file loader.

Keys and defaults are the JAX package's yacs tree (``get_cfg_defaults()``,
``cfg.VOICE2POSE.GENERATOR.NORM`` and so on), every key of it. ``load_config``
reads ``--config_file`` as the JAX ``main.py`` does: the defaults, then the
YAML file, then a flat ``KEY VALUE`` override list (``apply_overrides``, yacs'
``merge_from_list``), each leaf decoded and type-checked as yacs does. The
file is read by ``read_yaml``, the port's reader of the YAML subset that
``configs/*.yaml`` use (the card's host has no PyYAML); anything outside the
subset raises with its line number. Two defaults are the port's own: a
Voice2Pose file that leaves TRAIN.PRECISION unset trains at the flagship's
bf16, and DATASET.SPEAKER is 'oliver' where the file leaves it unset (JAX's
dataset refuses a None speaker, so no run JAX accepts reads otherwise).

The five parallel keys (SYS.DISTRIBUTED, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, MESH.DATA) start ranks over ``torch.distributed``
(``parallel/dist.py``, ``main.py``; ``check_config`` says how they map). Keys
the port reads and ignores or refuses (``check_config``): the XLA-only
keys (SYS.MEL_IMPL, FUSED_STEM, CONV_MM_GRAD, DEBUG_NANS, PLATFORM,
COMPILE_CACHE_DIR), CLIP_CODE.TRAIN and STRICT_LOADING change nothing the
port computes and are named by ``ignored_keys`` where set; DATASET.NAME must
be 'GestureDataset'.

The presets stand for the repository's ``configs/*.yaml`` in code (the tests
and the chip smoke run build them without a file): ``sdt_bp()`` (the
flagship, ``configs/voice2pose_sdt_bp.yaml``), ``sdt_vae()``, ``s2g()``,
``pose2pose()``, ``sdt_hubert()`` and ``sdt_wavlm()``, each equal to
``load_config`` of its file.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Optional


@dataclass
class ClipCodeConfig:
    DIMENSION: Optional[int] = None
    LR_SCALING: float = 1.0
    TRAIN: bool = True  # read nowhere by JAX: the learned bank trains either way
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
    STRICT_LOADING: bool = True  # JAX: restore checkpoint keys the state lacks; see ignored_keys
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
    NAME: str = "GestureDataset"  # the only dataset, in the port as in JAX
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
    SEQUENCE_PARALLEL: bool = False  # the exact demo, time axis split over the ranks
    LENGTH_BUCKET_S: float = 2.0  # read for the JAX YAMLs and ignored: clips run at their length


@dataclass
class ProfileConfig:
    ENABLED: bool = False
    START_STEP: int = 10  # global step where the torch.profiler window opens
    NUM_STEPS: int = 5
    OUT_DIR: Optional[str] = None  # default: <run>/profile


@dataclass
class MeshConfig:
    DATA: int = -1  # -1: every rank; > 0 must be the rank count (check_config)


@dataclass
class SysConfig:
    OUTPUT_DIR: str = "output/"
    CANVAS_SIZE: tuple = (720, 1280)  # (H, W) of a pose video's frames
    VISUALIZATION_SCALING: float = 0.85  # pixel-space poses are drawn at this scale
    VIDEO_FORMAT: list = field(default_factory=lambda: ["mp4", "img"])  # of VIDEO_FORMATS
    ASYNC_VIDEO_SAVING: bool = False  # videos drawn here, saved by a worker thread
    LOG_INTERVAL: int = 100  # steps between log lines
    NUM_WORKERS: int = 8  # loader worker processes (0: load in the training process)
    DISTRIBUTED: bool = False  # a process group even at one rank; torchrun's environment
    WORLD_SIZE: int = 1  # ranks (processes), one device each
    MASTER_ADDR: str = "localhost"
    MASTER_PORT: int = 21379
    MESH: MeshConfig = field(default_factory=MeshConfig)
    SEED: int = 0
    MEL_IMPL: str = "auto"  # the XLA-only keys: read and ignored
    FUSED_STEM: bool = False
    CONV_MM_GRAD: bool = False
    PROFILE: ProfileConfig = field(default_factory=ProfileConfig)
    DEBUG_NANS: bool = False
    PLATFORM: str = ""
    COMPILE_CACHE_DIR: str = "~/.cache/sdt_jax"


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


def sdt_hubert(speaker: Optional[str] = "oliver", precision: str = "bf16") -> Config:
    """SDT-BP's codes, UNet and decoder behind HuBERT Large's speech
    transformer (``SequenceGeneratorHuBERT``;
    ``configs/voice2pose_sdt_hubert.yaml``)."""
    cfg = _voice2pose(speaker, precision, external_code=False)
    cfg.VOICE2POSE.GENERATOR.NAME = "SequenceGeneratorHuBERT"
    return cfg


def sdt_wavlm(speaker: Optional[str] = "oliver", precision: str = "bf16") -> Config:
    """SDT-BP's codes, UNet and decoder behind WavLM Large's speech
    transformer (``SequenceGeneratorWavLM``;
    ``configs/voice2pose_sdt_wavlm.yaml``)."""
    cfg = sdt_hubert(speaker, precision)
    cfg.VOICE2POSE.GENERATOR.NAME = "SequenceGeneratorWavLM"
    return cfg


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
           "voice2pose_s2g": s2g, "pose2pose": pose2pose,
           "voice2pose_sdt_hubert": sdt_hubert, "voice2pose_sdt_wavlm": sdt_wavlm}
DEFAULT_SPEAKER = "oliver"
VIDEO_FORMATS = ("tensorboard", "mp4", "img")
XLA_ONLY_KEYS = ("SYS.MEL_IMPL", "SYS.FUSED_STEM", "SYS.CONV_MM_GRAD", "SYS.DEBUG_NANS",
                 "SYS.PLATFORM", "SYS.COMPILE_CACHE_DIR")
# what JAX does with these keys changes nothing the port computes (see ignored_keys)
NO_OP_KEYS = ("VOICE2POSE.STRICT_LOADING", "VOICE2POSE.GENERATOR.CLIP_CODE.TRAIN")


# ---- the YAML subset of configs/*.yaml -------------------------------------------------

class YAMLSubsetError(ValueError):
    """A construct outside the YAML subset that ``read_yaml`` reads."""


# PyYAML's (YAML 1.1) implicit resolvers, to refuse what they would type otherwise
_YAML_INT = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                       r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                         r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                         r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_YAML_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                          False)}
_NULLS = ("", "~", "null", "Null", "NULL")
_KEY_LINE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?=\s|$)")


def _plain_scalar(text: str, where: str, flow: bool = False):
    """An unquoted scalar as PyYAML's safe_load types it: null, bool, a
    decimal int, a float with a dot (YAML 1.1: ``1e-4`` stays a string, which
    yacs' decoding later makes a float), else a string."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    bad = ",[]{}#&*!|>%@`'\"" if flow else "[]{}#&*!|>%@`,"
    if (_YAML_INT.fullmatch(text) or _YAML_FLOAT.fullmatch(text)
            or _YAML_TIMESTAMP.match(text) or text in ("=", "<<") or text[0] in bad
            or (text[0] in "-?:" and (len(text) == 1 or text[1] == " "))
            or ": " in text or text.endswith(":") or " #" in text or "\t" in text):
        raise YAMLSubsetError(f"{where}: {text!r} is outside the YAML subset this reader "
                              "takes (quote it if it is a string)")
    return text


def _quoted(text: str, where: str):
    """A quoted scalar at the start of ``text`` -> (string, the rest of the line)."""
    q, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t"}.get(text[i + 1:i + 2])
            if esc is None:
                raise YAMLSubsetError(f"{where}: escape {text[i:i + 2]!r} is outside the "
                                      "YAML subset")
            out.append(esc)
            i += 2
            continue
        out.append(c)
        i += 1
    raise YAMLSubsetError(f"{where}: a quoted scalar must close on its line")


def _flow_list(text: str, where: str):
    """A one-line flow sequence of scalars at the start of ``text`` -> (list,
    the rest of the line)."""
    items, i, cur = [], 1, ""
    while i < len(text):
        c = text[i]
        if c in "'\"" and not cur.strip():
            value, rest = _quoted(text[i:], where)
            items.append(value)
            i = len(text) - len(rest)
            cur = None  # a quoted item is complete
            continue
        if c in ",]":
            if cur is not None and cur.strip():
                items.append(_plain_scalar(cur.strip(), where, flow=True))
            elif cur is not None and c == ",":  # ``[a, ]`` and ``[]`` close without one
                raise YAMLSubsetError(f"{where}: an empty item in a flow sequence")
            if c == "]":
                return items, text[i + 1:]
            cur = ""
        elif c in "[{}":
            raise YAMLSubsetError(f"{where}: nested flow collections are outside the YAML "
                                  "subset")
        elif cur is None:
            if not c.isspace():
                raise YAMLSubsetError(f"{where}: text after a quoted item in a flow sequence")
        else:
            cur += c
        i += 1
    raise YAMLSubsetError(f"{where}: a flow sequence must close on its line")


def _value(text: str, where: str):
    if text[0] in "'\"":
        value, rest = _quoted(text, where)
    elif text[0] == "[":
        value, rest = _flow_list(text, where)
    else:
        end = text.find(" #")
        value, rest = _plain_scalar((text if end < 0 else text[:end]).rstrip(), where), ""
    if rest.strip() and not re.match(r"\s+#", rest):
        raise YAMLSubsetError(f"{where}: unexpected text {rest.strip()!r} after the value")
    return value


def parse_yaml(text: str, name: str = "<yaml>"):
    """The YAML subset of ``configs/*.yaml``: nested block mappings of plain
    keys, ``#`` comments, and values that are quoted or plain scalars (null,
    bools, ints, floats, strings) or one-line flow sequences of them. Returns
    what ``yaml.safe_load`` would (None for a file of comments); anything
    outside the subset raises ``YAMLSubsetError`` naming the line."""
    root: dict = {}
    # open mappings: [indent of their keys (None until the first), the dict, its key]
    frames = [[None, root, None]]
    seen = False
    for ln, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{ln}"
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body[0] == "\t" or body.startswith(("---", "...", "%", "- ", "? ")) or body == "-":
            raise YAMLSubsetError(f"{where}: tabs, documents, directives, block sequences and "
                                  "complex keys are outside the YAML subset")
        indent, seen = len(raw) - len(body), True
        top = frames[-1]
        if top[0] is None:
            parent = frames[-2][0] if len(frames) > 1 else -1
            if indent > parent:
                top[0] = indent
            else:  # ``KEY:`` with nothing under it is null
                frames.pop()
                frames[-1][1][top[2]] = None
        while indent < frames[-1][0]:
            frames.pop()
        if indent != frames[-1][0]:
            raise YAMLSubsetError(f"{where}: indentation {indent} matches no open mapping")
        m = _KEY_LINE.match(body)
        if m is None:
            raise YAMLSubsetError(f"{where}: expected 'KEY:' or 'KEY: value' with a plain key")
        key, rest = m.group(1), body[m.end():]
        node = frames[-1][1]
        if key in node:
            raise YAMLSubsetError(f"{where}: duplicate key {key!r}")
        if not rest.strip() or rest.lstrip().startswith("#"):
            node[key] = {}
            frames.append([None, node[key], key])
        else:
            node[key] = _value(rest.strip(), where)
    if len(frames) > 1 and frames[-1][0] is None:
        frames[-2][1][frames[-1][2]] = None
    return root if seen else None


def read_yaml(path: str):
    """``parse_yaml`` of the file at ``path``."""
    with open(path) as f:
        return parse_yaml(f.read(), path)


# ---- merging -----------------------------------------------------------------------

def _decode(value):
    """A string value as a Python literal where it parses as one, else the
    string itself; other values as they are (yacs' ``_decode_cfg_value``)."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(old, new, key: str):
    """yacs' ``_check_and_coerce_cfg_value_type``: the new value must have the
    old one's type, unless either is None; a list and a tuple convert into
    each other and an int into a float."""
    if type(new) is type(old) or old is None or new is None:
        return new
    for src, dst in ((tuple, list), (list, tuple), (int, float)):
        if type(new) is src and type(old) is dst:
            return dst(new)
    raise ValueError(f"Type mismatch ({type(old)} vs. {type(new)}) with values "
                     f"({old} vs. {new}) for config key: {key}")


def _leaf_parent(cfg, key: str):
    *path, leaf = key.split(".")
    node = cfg
    for part in path:
        node = getattr(node, part, None)
        if not is_dataclass(node):
            raise KeyError(f"Non-existent config key: {key}")
    if leaf not in {f.name for f in fields(node)} or is_dataclass(getattr(node, leaf)):
        raise KeyError(f"Non-existent config key: {key}")
    return node, leaf


def get_key(cfg, key: str):
    """The value of a dotted key, e.g. ``get_key(cfg, "SYS.MESH.DATA")``."""
    node, leaf = _leaf_parent(cfg, key)
    return getattr(node, leaf)


def apply_overrides(cfg: Config, opts: list) -> Config:
    """Merge ``["KEY", "VALUE", ...]`` into ``cfg`` in place and return it, as
    yacs' ``merge_from_list``: each value decoded as a literal, then held to
    the key's type by ``_coerce``."""
    if len(opts) % 2:
        raise ValueError(f"overrides must be KEY VALUE pairs, got {opts}")
    for key, raw in zip(opts[0::2], opts[1::2]):
        node, leaf = _leaf_parent(cfg, key)
        setattr(node, leaf, _coerce(getattr(node, leaf), _decode(raw), key))
    return cfg


def merge_tree(cfg: Config, tree: dict, prefix: str = "") -> Config:
    """Merge a loaded YAML mapping into ``cfg`` in place, as yacs'
    ``merge_from_file``: every leaf decoded and type-checked."""
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, dict):
            node = getattr(cfg, k, None) if is_dataclass(cfg) else None
            if not is_dataclass(node):
                raise KeyError(f"Non-existent config key (or not a node): {key}")
            merge_tree(node, v, key + ".")
        else:
            if not hasattr(cfg, k) or is_dataclass(getattr(cfg, k)):
                raise KeyError(f"Non-existent config key: {key}")
            setattr(cfg, k, _coerce(getattr(cfg, k), _decode(v), key))
    return cfg


def load_config(path: Optional[str] = None, opts=()) -> Config:
    """The JAX ``main.py``'s configuration: the defaults, the YAML file at
    ``path``, then the ``KEY VALUE`` overrides; without a file, the SDT-BP
    preset (``configs/voice2pose_sdt_bp.yaml``'s tree). ``check_config``
    holds the result."""
    if path:
        tree = read_yaml(path) or {}
        cfg = Config()
        cfg.DATASET.SPEAKER = DEFAULT_SPEAKER
        merge_tree(cfg, tree)
        if cfg.PIPELINE_TYPE == "Voice2Pose" and "PRECISION" not in (tree.get("TRAIN") or {}):
            cfg.TRAIN.PRECISION = "bf16"
    else:
        cfg = sdt_bp()
    apply_overrides(cfg, list(opts))
    check_config(cfg)
    return cfg


def check_config(cfg: Config) -> None:
    """Raise ValueError for a value the port does not run: another dataset,
    an unknown video format, or parallel keys that do not map onto ranks.

    The parallel keys map onto ``torch.distributed`` ranks (``main.py``,
    ``parallel/dist.py``): SYS.WORLD_SIZE is the number of ranks, one process
    and one device each (more than 1 on one host: ``main`` spawns them).
    SYS.MESH.DATA, when > 0, must equal that rank count: JAX's mesh is
    devices in one process, the port's is processes. SYS.DISTRIBUTED means
    the ranks may span hosts: they meet at SYS.MASTER_ADDR:SYS.MASTER_PORT, or
    through the RANK / WORLD_SIZE / LOCAL_RANK environment that ``torchrun``
    sets, and a process group runs even at one rank. The defaults run one
    process without a group, as before the ranks were ported."""
    if cfg.SYS.WORLD_SIZE < 1:
        raise ValueError(f"SYS.WORLD_SIZE {cfg.SYS.WORLD_SIZE}: the number of ranks, >= 1")
    if cfg.SYS.MESH.DATA > 0 and cfg.SYS.MESH.DATA != cfg.SYS.WORLD_SIZE:
        raise ValueError(
            f"SYS.MESH.DATA {cfg.SYS.MESH.DATA} with SYS.WORLD_SIZE {cfg.SYS.WORLD_SIZE}: JAX's "
            "mesh is the devices of one process, the port's is its ranks (one process and one "
            "device each), so SYS.MESH.DATA must be -1 or the rank count, SYS.WORLD_SIZE")
    if cfg.DATASET.NAME != "GestureDataset":
        raise ValueError(f"DATASET.NAME {cfg.DATASET.NAME!r}: the port has 'GestureDataset' "
                         "only, as JAX's dataset registry does")
    unknown = [f for f in cfg.SYS.VIDEO_FORMAT if f not in VIDEO_FORMATS]
    if unknown:
        raise ValueError(f"SYS.VIDEO_FORMAT {cfg.SYS.VIDEO_FORMAT}: {unknown} not of "
                         f"{VIDEO_FORMATS}")


def ignored_keys(cfg: Config) -> list:
    """The keys set away from their defaults that the port reads and ignores:
    the XLA-only ones, CLIP_CODE.TRAIN (which JAX reads nowhere) and
    STRICT_LOADING (JAX keeps a restored checkpoint's keys that its state
    lacks, or with False skips them; the port loads each module it has
    strictly and never carries a part it has no module for)."""
    defaults = Config()
    return [f"{k} {get_key(cfg, k)!r}" for k in XLA_ONLY_KEYS + NO_OP_KEYS
            if get_key(cfg, k) != get_key(defaults, k)]
