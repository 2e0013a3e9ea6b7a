"""Generator weights from a JAX parameter tree or a reference-layout ``.pth``.

``params_from_jax`` walks the JAX generator's param tree (nested dicts of
arrays) and names each conv after the reference torch attribute, transposing
HWIO -> OIHW and WIO -> OIW; the result loads into ``SequenceGeneratorCNN``
with ``strict=True``. ``load_reference_pth`` reads the reference checkpoint
layout ``{epoch, step, model_state_dict}`` with ``module.netG.`` keys (what
the JAX package's ``main.py --export_torch`` writes).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _conv_to_torch(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w)
    if w.ndim == 3:  # (W, I, O) -> (O, I, W)
        return np.transpose(w, (2, 1, 0))
    if w.ndim == 4:  # (H, W, I, O) -> (O, I, H, W)
        return np.transpose(w, (3, 2, 0, 1))
    raise ValueError(f"unexpected conv kernel ndim {w.ndim}")


def reverse_generator(path: Path) -> str:
    """JAX generator param path -> reference torch module path."""
    if path[0] == "audio_encoder":
        n = int(path[1].rsplit("_", 1)[1])
        return f"audio_encoder.specgram_encoder_2d.{n // 2}.{n % 2}"
    if path[0] == "unet":
        return f"unet.{path[1]}"
    if path[0].startswith("decoder_"):
        tail = path[0].rsplit("_", 1)[1]
        return f"decoder.{4 if tail == 'out' else int(tail)}"
    raise KeyError(f"unmapped generator path {path}")


def params_from_jax(params_g: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SequenceGeneratorCNN`` params -> the port's state_dict (float32).

    IN-normalized generators only: convs, no norm parameters or statistics."""
    sd: Dict[str, np.ndarray] = {}

    def visit(path: Path, node: Any):
        if not isinstance(node, dict):
            return
        if "conv" in node or "norm" in node:  # a ConvNormRelu parent
            if "norm" in node:
                raise NotImplementedError("normalization parameters (BN) are not ported")
            sd[f"{reverse_generator(path)}.conv.weight"] = _conv_to_torch(
                node["conv"]["kernel"])
            return
        if "kernel" in node:  # the final conv (no norm wrapper)
            tparent = reverse_generator(path)
            sd[f"{tparent}.weight"] = _conv_to_torch(node["kernel"])
            if "bias" in node:
                sd[f"{tparent}.bias"] = np.asarray(node["bias"])
            return
        for k, v in node.items():
            visit(path + (k,), v)

    visit((), params_g)
    if not sd:
        raise ValueError("no generator parameters found")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """The generator's state_dict out of a reference-layout checkpoint.

    Keys are ``module.netG.<name>`` (or ``netG.<name>`` without the
    DataParallel prefix); every other entry (mel buffers, clip codes, pose
    encoder) is left out."""
    prefix = "netG."
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    msd = ckpt.get("model_state_dict", ckpt)
    out = {}
    for k, v in msd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(prefix):
            out[k[len(prefix):]] = v.float()
    if not out:
        raise KeyError(f"no {prefix!r} entries in {path}")
    return out
