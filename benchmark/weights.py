"""The benchmark's seeded inputs and weights, made on the device in a few
large draws from a ``torch.Generator`` on the card.

Weights are handed to the port and to the reference alike, keyed by the
reference repository's parameter names (``reference.generator.leaves``).
Convolutions are Kaiming-normal (fan-in, gain sqrt 2), as the published model
initializes them; the output 1x1 is LeCun-normal with a small seeded bias; a
BN layer's scale, shift and running statistics are seeded near (1, 0, 0, 1).
"""

import math
from typing import Dict

import numpy as np
import torch

from .reference import generator as ref_gen


def seed_stream(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's ``--seed``; any whole number works."""
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), *tag.encode()])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64) @ np.array([1, 2 ** 32],
                                                                             np.uint64)) >> 1


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_stream(seed, tag))


def generator_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every generator parameter and buffer of the configuration, float32."""
    leaves = ref_gen.leaves(model["code_dim"], model["norm"], model["num_landmarks"])
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=device_generator(seed, "weights", device),
                       device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        z = flat[at:at + n].view(shape)
        at += n
        if kind in ("conv", "out_weight"):
            fan_in = math.prod(shape[1:])
            z = z * math.sqrt((2.0 if kind == "conv" else 1.0) / fan_in)
        elif kind == "out_bias":
            z = z * 0.1
        elif kind == "bn_weight":
            z = 1.0 + 0.1 * z
        elif kind in ("bn_bias", "bn_mean"):
            z = 0.1 * z
        elif kind == "bn_var":
            z = torch.exp(0.2 * z)
        out[name] = z.contiguous()
    return out


def port_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the port's ``SequenceGeneratorCNN`` loads them: a BN
    layer also carries ``num_batches_tracked``."""
    sd = dict(weights)
    for name in weights:
        if name.endswith(".norm.running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=weights[name].device)
    return sd


def speech_like_audio(n: int, length: int, gen: torch.Generator, device,
                      sample_rate: int = 16000) -> torch.Tensor:
    """(n, length) float32: white noise under a syllable-rate envelope (3-6 Hz)
    and a per-clip gain spanning 30 dB, so the mel sees a speech-like dynamic
    range."""
    noise = torch.randn(n, length, generator=gen, device=device)
    u = torch.rand(n, 3, 1, generator=gen, device=device)
    t = torch.arange(length, device=device, dtype=torch.float32) / sample_rate
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * (3.0 + 3.0 * u[:, 0]) * t + 2 * math.pi * u[:, 1])
    gain = 0.1 * torch.pow(10.0, -1.5 * u[:, 2])
    return (noise * env * gain).contiguous()
