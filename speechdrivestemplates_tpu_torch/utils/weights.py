"""Weights from a JAX parameter tree or a reference-layout ``.pth``.

``params_from_jax`` and ``pose_encoder_params_from_jax`` walk a JAX module's
param tree (nested dicts of arrays) and its batch statistics, and name each
tensor after the reference torch attribute: conv kernels transposed HWIO ->
OIHW and WIO -> OIW, norm ``scale``/``bias`` -> ``weight``/``bias``, batch
statistics ``mean``/``var`` -> ``running_mean``/``running_var`` (with a zero
``num_batches_tracked``). The results load into the port's modules with
``strict=True``. ``discriminator_params_from_jax`` does the same for s2g's
``PoseSequenceDiscriminator``. ``state_from_jax`` takes the trained parts out
of a JAX ``Voice2Pose.state``. ``load_reference_pth`` reads the generator out of the
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


def reverse_discriminator(path: Path) -> str:
    """JAX discriminator param path -> reference torch module path."""
    if path[0].startswith("ConvNormRelu_"):
        return f"seq.{int(path[0].rsplit('_', 1)[1])}"
    if path[0] == "Conv_0":
        return "seq.3"
    raise KeyError(f"unmapped discriminator path {path}")


def reverse_pose_encoder(path: Path) -> str:
    """JAX pose-encoder param path -> reference torch module path."""
    if path[0].startswith("ConvNormRelu_"):
        return f"blocks.{int(path[0].rsplit('_', 1)[1])}"
    raise KeyError(f"unmapped pose-encoder path {path}")


def reverse_autoencoder(path: Path) -> str:
    """JAX autoencoder param path -> reference torch module path."""
    if path[0] == "encoder":
        return "encoder." + reverse_pose_encoder(path[1:])
    if path[0] == "decoder":
        sub = path[1]
        if sub in ("d5", "d4", "d3", "d2", "d1"):
            return f"decoder.{sub}"
        if sub.startswith("block_"):
            return f"decoder.blocks.{int(sub.rsplit('_', 1)[1])}"
        if sub == "out":
            return "decoder.blocks.4"
    raise KeyError(f"unmapped autoencoder path {path}")


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


def discriminator_params_from_jax(params_d: Dict[str, Any],
                                  batch_stats_d: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PoseSequenceDiscriminator`` params and batch statistics -> the
    port's discriminator state_dict (float32)."""
    return _module_from_jax(params_d, batch_stats_d, reverse_discriminator)


def pose_encoder_params_from_jax(params_pe: Dict[str, Any],
                                 batch_stats_pe: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``PoseSeqEncoder`` params and batch statistics -> the port's
    ``PoseSeqEncoder`` state_dict (float32)."""
    return _module_from_jax(params_pe, batch_stats_pe, reverse_pose_encoder)


def state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``Voice2Pose.state`` (host arrays) -> ``{"generator": state_dict,
    "clips_code": tensor or None (a code-less generator), "pose_encoder":
    state_dict}``, with ``"discriminator": state_dict`` where the state has
    one: the parts the port's train state loads (``Voice2PoseTrainState.load``)."""
    bank = state.get("clips_code")
    out = {
        "generator": params_from_jax(state["params_g"], state.get("batch_stats_g")),
        "clips_code": None if bank is None else torch.tensor(np.asarray(bank, np.float32)),
        "pose_encoder": pose_encoder_params_from_jax(state["params_pe"],
                                                     state["batch_stats_pe"]),
    }
    if state.get("params_d"):
        out["discriminator"] = discriminator_params_from_jax(state["params_d"],
                                                             state["batch_stats_d"])
    return out


def autoencoder_params_from_jax(params_ae: Dict[str, Any],
                                batch_stats_ae: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``Autoencoder`` params and batch statistics -> the port's
    ``Autoencoder`` state_dict (float32)."""
    return _module_from_jax(params_ae, batch_stats_ae, reverse_autoencoder)


def pose2pose_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ``Pose2Pose.state`` (host arrays) -> ``{"autoencoder": state_dict,
    "clip_code_mu": tensor, "clip_code_logvar": tensor}``
    (``Pose2PoseTrainState.load``)."""
    out = {"autoencoder": autoencoder_params_from_jax(state["params_ae"],
                                                      state["batch_stats_ae"])}
    for k in ("clip_code_mu", "clip_code_logvar"):
        out[k] = torch.tensor(np.asarray(state[k], dtype=np.float32))
    return out


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout checkpoint's ``model_state_dict`` (or a bare state
    dict), with the DataParallel ``module.`` prefix taken off every key."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    msd = ckpt.get("model_state_dict", ckpt)
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in msd.items()}


def _under(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: (v.float() if v.is_floating_point() else v)
            for k, v in sd.items() if k.startswith(prefix)}


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """The generator's state_dict (``netG.*``) out of a reference-layout
    checkpoint; every other entry is left out."""
    out = _under(read_pth(path), "netG.")
    if not out:
        raise KeyError(f"no 'netG.' entries in {path}")
    return out


def pose_encoder_from_ae_pth(path: str, expected) -> Dict[str, torch.Tensor]:
    """The frozen FGD encoder's state_dict out of a Pose2Pose checkpoint's
    ``ae.encoder.*`` entries. Raises unless they are exactly the tensors of
    ``expected`` (an encoder's state_dict keys): a tensor left at its random
    init would compute meaningless FGD without an error."""
    out = _under(read_pth(path), "ae.encoder.")
    missing, extra = sorted(set(expected) - set(out)), sorted(set(out) - set(expected))
    if missing or extra:
        raise ValueError(f"AE checkpoint {path!r} does not fill the frozen encoder: "
                         f"missing {missing[:6]}, unexpected {extra[:6]}; its encoder "
                         "architecture does not match VOICE2POSE.POSE_ENCODER")
    return out


def check_bank_rows(bank: torch.Tensor, num_train: Optional[int]) -> None:
    """A template bank has one code per train clip: a bank of another size would
    index the wrong clips' codes (torch's strict load raises on it too)."""
    if num_train is not None and bank.shape[0] != num_train:
        raise ValueError(f"clip-code bank has {bank.shape[0]} rows but the train split "
                         f"has {num_train} clips; template codes are per clip, so a "
                         "checkpoint can only continue on the dataset it was trained on")


def external_code_bank(path: str, num_train: Optional[int]) -> torch.Tensor:
    """SDT-VAE's template bank: the ``clip_code_mu`` of a Pose2Pose checkpoint,
    one row per train clip (``num_train``; None takes any number)."""
    sd = read_pth(path)
    if "clip_code_mu" not in sd:
        raise KeyError(f"no 'clip_code_mu' bank in {path}: not a Pose2Pose checkpoint")
    bank = sd["clip_code_mu"].float()
    check_bank_rows(bank, num_train)
    return bank
