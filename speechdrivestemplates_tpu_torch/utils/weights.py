"""Weights from a JAX parameter tree or a reference-layout ``.pth``.

``params_from_jax`` and ``pose_encoder_params_from_jax`` walk a JAX module's
param tree (nested dicts of arrays) and its batch statistics, and name each
tensor after the reference torch attribute: conv kernels transposed HWIO ->
OIHW and WIO -> OIW, norm ``scale``/``bias`` -> ``weight``/``bias``, batch
statistics ``mean``/``var`` -> ``running_mean``/``running_var`` (with a zero
``num_batches_tracked``). The results load into the port's modules with
``strict=True``. ``state_from_jax`` takes all three trained parts out of a JAX
``Voice2Pose.state``. ``load_reference_pth`` reads the generator out of the
reference checkpoint layout ``{epoch, step, model_state_dict}`` with
``module.netG.`` keys, which the port's trainer and the JAX package's
``main.py --export_torch`` write.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

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


def reverse_pose_encoder(path: Path) -> str:
    """JAX pose-encoder param path -> reference torch module path."""
    if path[0].startswith("ConvNormRelu_"):
        return f"blocks.{int(path[0].rsplit('_', 1)[1])}"
    raise KeyError(f"unmapped pose-encoder path {path}")


def _module_from_jax(params: Dict[str, Any], batch_stats: Optional[Dict[str, Any]],
                     reverse: Callable[[Path], str],
                     dtype=np.float32) -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}

    def stats_at(path: Path):
        node = batch_stats or {}
        for p in path:
            node = node.get(p, {}) if isinstance(node, dict) else {}
        return node or None

    def visit(path: Path, node: Any):
        if not isinstance(node, dict):
            return
        if "conv" in node or "norm" in node:  # a ConvNormRelu parent
            name = reverse(path)
            sd[f"{name}.conv.weight"] = _conv_to_torch(node["conv"]["kernel"])
            if "norm" in node:
                stats = stats_at(path + ("norm",))
                if stats is None:
                    raise ValueError(f"no batch statistics for the norm at {path}")
                sd[f"{name}.norm.weight"] = node["norm"]["scale"]
                sd[f"{name}.norm.bias"] = node["norm"]["bias"]
                sd[f"{name}.norm.running_mean"] = stats["mean"]
                sd[f"{name}.norm.running_var"] = stats["var"]
            return
        if "kernel" in node:  # a final conv (no norm wrapper)
            name = reverse(path)
            sd[f"{name}.weight"] = _conv_to_torch(node["kernel"])
            if "bias" in node:
                sd[f"{name}.bias"] = node["bias"]
            return
        for k, v in node.items():
            visit(path + (k,), v)

    visit((), params)
    if not sd:
        raise ValueError("no parameters found")
    out = {k: torch.tensor(np.asarray(v, dtype=dtype)) for k, v in sd.items()}
    for k in [k for k in out if k.endswith(".norm.running_var")]:
        out[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
    return out


def params_from_jax(params_g: Dict[str, Any],
                    batch_stats_g: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """JAX ``SequenceGeneratorCNN`` params (and batch statistics, for BN
    generators) -> the port's state_dict (float32)."""
    return _module_from_jax(params_g, batch_stats_g, reverse_generator)


def pose_encoder_params_from_jax(params_pe: Dict[str, Any],
                                 batch_stats_pe: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PoseSeqEncoder`` params and batch statistics -> the port's
    ``PoseSeqEncoder`` state_dict (float32)."""
    return _module_from_jax(params_pe, batch_stats_pe, reverse_pose_encoder)


def state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``Voice2Pose.state`` (host arrays) -> ``{"generator": state_dict,
    "clips_code": tensor, "pose_encoder": state_dict}``, the parts the port's
    train state loads (``Voice2PoseTrainState.load``)."""
    return {
        "generator": params_from_jax(state["params_g"], state.get("batch_stats_g")),
        "clips_code": torch.tensor(np.asarray(state["clips_code"], dtype=np.float32)),
        "pose_encoder": pose_encoder_params_from_jax(state["params_pe"],
                                                     state["batch_stats_pe"]),
    }


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
            out[k[len(prefix):]] = v.float() if v.is_floating_point() else v
    if not out:
        raise KeyError(f"no {prefix!r} entries in {path}")
    return out
