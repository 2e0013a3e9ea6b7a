"""The benchmark's seeded inputs and weights, made on the device in a few
large draws from a ``torch.Generator`` on the card.

Weights are handed to the port and to the reference alike, keyed by the
reference's parameter names: a configuration's model module
(``models/<name>.py``) lists them as ``leaves(model)``, each with a kind, and
maps each kind to its init (``INIT``). Every leaf is cut, in order, from one
standard-normal draw of the seed's ``weights`` stream and scaled by its
kind's init. ``INIT`` below holds the kinds of the published models:
convolutions are Kaiming-normal (fan-in, gain sqrt 2), as the published model
initializes them; the output 1x1 is LeCun-normal with a small seeded bias; a
BN layer's scale, shift and running statistics are seeded near (1, 0, 0, 1).
"""

import math
from typing import Callable, Dict

import numpy as np
import torch


def seed_stream(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's ``--seed``; any whole number works."""
    ss = np.random.SeedSequence([seed & (2 ** 64 - 1), *tag.encode()])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64) @ np.array([1, 2 ** 32],
                                                                             np.uint64)) >> 1


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_stream(seed, tag))


def _fan_in(z: torch.Tensor) -> int:
    return math.prod(z.shape[1:])


# a leaf's kind -> its value from the leaf's standard-normal draw ``z``
INIT: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "conv": lambda z: z * math.sqrt(2.0 / _fan_in(z)),
    "out_weight": lambda z: z * math.sqrt(1.0 / _fan_in(z)),
    "out_bias": lambda z: z * 0.1,
    "bn_weight": lambda z: 1.0 + 0.1 * z,
    "bn_bias": lambda z: 0.1 * z,
    "bn_mean": lambda z: 0.1 * z,
    "bn_var": lambda z: torch.exp(0.2 * z),
}


def seeded_weights(model_module, model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the configuration's model, float32: the
    leaves of ``model_module.leaves(model)`` cut from one draw of the seed,
    each through ``model_module.INIT`` of its kind (an unknown kind raises)."""
    leaves = model_module.leaves(model)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=device_generator(seed, "weights", device),
                       device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        z = flat[at:at + n].view(shape)
        at += n
        out[name] = model_module.INIT[kind](z).contiguous()
    return out


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
