"""``SequenceGeneratorHuBERT``: SDT-BP's template codes, UNet and decoder
behind HuBERT Large's speech transformer. Its math is
``reference/speech_encoder.py`` (the forward) and ``reference/pose.py``; it
serves only (no training configuration).

Seeded weights, by kind: linears N(0, 0.02), HuBERT's ``initializer_range``;
convolutions Kaiming-normal; the positional convolution's ``weight_v`` N(0,
2 / sqrt(kernel x channels a group)), as HuBERT initializes it. Where HuBERT's
init leaves a value that would hide a fault of the program from the check,
the seed moves it: biases N(0, 0.02) (HuBERT's are 0), LayerNorms 1 + 0.1 z
and 0.1 z (HuBERT's are (1, 0)), and ``weight_g`` 2 sqrt(hidden / kernel)
(1 + 0.1 z), near the norm of ``weight_v`` (HuBERT's is that norm, which
makes the folded weight ``weight_v`` itself)."""

import math
from typing import Callable, Dict, Optional

import torch

from .. import correct, weights
from ..reference import no_tf32
from ..reference import pose as ref_pose
from ..reference import speech_encoder as ref_se

KERNELS = ["in_act"]
# |weight_v| over each kernel tap at HuBERT's init and the published widths: 2 sqrt(1024 / 128)
POS_CONV_G = 2.0 * math.sqrt(1024 / 128)
INIT: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    **weights.INIT,
    "hubert_linear": lambda z: 0.02 * z,
    "hubert_bias": lambda z: 0.02 * z,
    "ln_weight": lambda z: 1.0 + 0.1 * z,
    "ln_bias": lambda z: 0.1 * z,
    "pos_conv_v": lambda z: z * 2.0 * math.sqrt(1.0 / math.prod(z.shape[1:])),
    "pos_conv_g": lambda z: POS_CONV_G * (1.0 + 0.1 * z),
}
# the encoder's widths in the configuration, under the published config's keys
WIDTHS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
          "conv_dim", "conv_kernel", "conv_stride", "num_conv_pos_embeddings",
          "num_conv_pos_embedding_groups", "layer_norm_eps")


def leaves(m: dict) -> list:
    return ref_se.leaves(m)


def port_keys(cfg) -> dict:
    """The configuration tree's numbers and the encoder's widths from the
    port's table of the generator that the tree names."""
    from speechdrivestemplates_tpu_torch.models import MODELS

    g = cfg.VOICE2POSE.GENERATOR
    spec = MODELS[g.NAME].SPEC
    out = {k: (list(v) if isinstance(v, tuple) else v)
           for k, v in ((k, getattr(spec, k)) for k in WIDTHS)}
    out.update({"norm": g.NORM, "code_dim": g.CLIP_CODE.DIMENSION,
                "leaky_slope": 0.2 if g.LEAKY_RELU else 0.0,
                "num_landmarks": cfg.DATASET.NUM_LANDMARKS,
                "num_frames": cfg.DATASET.NUM_FRAMES, "audio_length": cfg.DATASET.AUDIO_LENGTH,
                "sample_rate": cfg.DATASET.AUDIO_SR, "fps": cfg.DATASET.FPS,
                "hierarchical_pose": cfg.DATASET.HIERARCHICAL_POSE,
                "speaker": cfg.DATASET.SPEAKER, "precision": cfg.TRAIN.PRECISION})
    return out


def port_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``SequenceGeneratorHuBERT`` takes the reference's names."""
    return dict(weights)


def reference_poses(weights: Dict[str, torch.Tensor], audio: torch.Tensor,
                    code: Optional[torch.Tensor], m: dict, stat: dict,
                    num_frames: Optional[int] = None, quant: Optional[Callable] = None
                    ) -> torch.Tensor:
    """Pixel-space poses of the reference for (B, L) audio, in blocks of rows."""
    out = []
    with no_tf32(), torch.no_grad():
        for a in range(0, audio.shape[0], correct.BLOCK):
            c = None if code is None else code[a:a + correct.BLOCK]
            pred = ref_se.forward(weights, audio[a:a + correct.BLOCK],
                                  num_frames or m["num_frames"], c, m, quant)
            out.append(ref_pose.final_poses(pred, stat, m["hierarchical_pose"]))
    return torch.cat(out)
