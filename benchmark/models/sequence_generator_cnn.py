"""``SequenceGeneratorCNN``, the generator of SDT-BP, SDT-VAE and s2g-GAN:
the model of every configuration that names no ``model_module``. Its math is
``reference/generator.py`` (the forward), ``reference/mel.py``,
``reference/pose.py`` and ``reference/train.py`` (SDT-BP's step: L1 and the
code KL, Adam on the generator and the code bank)."""

from typing import Callable, Dict, Optional

import torch

from .. import correct, weights
from ..reference import generator as ref_gen
from ..reference import mel as ref_mel
from ..reference import no_tf32
from ..reference import pose as ref_pose
from ..reference import train as ref_train

KERNELS = ["mel", "conv1", "stem"]
INIT = weights.INIT  # its kinds: conv, out_weight, out_bias, bn_*


def leaves(m: dict) -> list:
    return ref_gen.leaves(m["code_dim"], m["norm"], m["num_landmarks"])


def port_keys(cfg) -> dict:
    g = cfg.VOICE2POSE.GENERATOR
    return {"norm": g.NORM, "code_dim": g.CLIP_CODE.DIMENSION,
            "leaky_slope": 0.2 if g.LEAKY_RELU else 0.0,
            "num_landmarks": cfg.DATASET.NUM_LANDMARKS, "num_frames": cfg.DATASET.NUM_FRAMES,
            "audio_length": cfg.DATASET.AUDIO_LENGTH, "sample_rate": cfg.DATASET.AUDIO_SR,
            "fps": cfg.DATASET.FPS, "hierarchical_pose": cfg.DATASET.HIERARCHICAL_POSE,
            "speaker": cfg.DATASET.SPEAKER, "lambda_reg": g.LAMBDA_REG,
            "lambda_clip_kl": g.LAMBDA_CLIP_KL, "lr": cfg.TRAIN.LR,
            "code_lr_scaling": g.CLIP_CODE.LR_SCALING, "weight_decay": cfg.TRAIN.WD,
            "precision": cfg.TRAIN.PRECISION}


def port_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the port's ``SequenceGeneratorCNN`` loads them: a BN
    layer also carries ``num_batches_tracked``."""
    sd = dict(weights)
    for name in weights:
        if name.endswith(".norm.running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=weights[name].device)
    return sd


def port_parts(state, weights: Dict[str, torch.Tensor], bank: torch.Tensor) -> dict:
    return {"generator": port_state_dict(weights), "clips_code": bank,
            "pose_encoder": state.pose_encoder.state_dict()}


def reference_poses(weights: Dict[str, torch.Tensor], audio: torch.Tensor,
                    code: Optional[torch.Tensor], m: dict, stat: dict,
                    num_frames: Optional[int] = None, quant: Optional[Callable] = None
                    ) -> torch.Tensor:
    """Pixel-space poses of the reference for (B, L) audio, in blocks of rows."""
    out = []
    with no_tf32(), torch.no_grad():
        for a in range(0, audio.shape[0], correct.BLOCK):
            spec = ref_mel.mel_spectrogram(audio[a:a + correct.BLOCK])
            c = None if code is None else code[a:a + correct.BLOCK]
            pred = ref_gen.forward(weights, spec, num_frames or m["num_frames"], c, m["norm"],
                                   m["leaky_slope"], m["num_landmarks"], quant)
            out.append(ref_pose.final_poses(pred, stat, m["hierarchical_pose"]))
    return torch.cat(out)


def reference_steps(weights, bank, batches, m: dict, quant: Optional[Callable] = None) -> dict:
    with no_tf32():
        return ref_train.run_steps(weights, bank, batches, m, quant)


def first_grads(state) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient as the port's Adam got it at step 1: its first
    moment over (1 - beta1) (no weight decay in the configurations); zero
    where the optimizer holds no moment for it. The bank is leaf
    ``clips_code``."""
    pairs = [(name, p, state.opt_g) for name, p in state.generator.named_parameters()]
    pairs.append(("clips_code", state.clips_code, state.opt_code))
    out = {}
    for name, p, opt in pairs:
        m = opt.state.get(p, {}).get("exp_avg")
        out[name] = (torch.zeros_like(p, dtype=torch.float32) if m is None
                     else m.detach().float() / (1 - ref_train.BETAS[0]))
    return out


def changes(state, weights: Dict[str, torch.Tensor], bank0: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    out = {name: (p.detach().float() - weights[name]).clone()
           for name, p in state.generator.named_parameters()}
    out["clips_code"] = (state.clips_code.detach().float() - bank0).clone()
    return out
