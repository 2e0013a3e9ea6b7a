"""A toy architecture (``reference/toy_mel_head.py``): the mel, a resize and
a gained 1x1 projection. Its gain is a leaf kind of its own, ``toy_gain``."""

from typing import Callable, Dict, Optional

import torch

from .. import correct, weights
from ..reference import mel as ref_mel
from ..reference import no_tf32
from ..reference import pose as ref_pose
from ..reference import toy_mel_head as ref_toy

KERNELS = ["mel"]
INIT = {**weights.INIT, "toy_gain": lambda z: 1.0 + 0.05 * z}


def leaves(m: dict) -> list:
    c = 2 * m["num_landmarks"]
    return [("proj.weight", (c, ref_mel.N_MELS), "out_weight"),
            ("proj.gain", (c,), "toy_gain"), ("proj.bias", (c,), "out_bias")]


def reference_poses(weights: Dict[str, torch.Tensor], audio: torch.Tensor,
                    code: Optional[torch.Tensor], m: dict, stat: dict,
                    num_frames: Optional[int] = None, quant: Optional[Callable] = None
                    ) -> torch.Tensor:
    out = []
    with no_tf32(), torch.no_grad():
        for a in range(0, audio.shape[0], correct.BLOCK):
            spec = ref_mel.mel_spectrogram(audio[a:a + correct.BLOCK])
            pred = ref_toy.forward(weights, spec, num_frames or m["num_frames"],
                                   m["num_landmarks"], quant)
            out.append(ref_pose.final_poses(pred, stat, m["hierarchical_pose"]))
    return torch.cat(out)
