"""``SequenceGeneratorWavLM``: SDT-BP's template codes, UNet and decoder
behind WavLM Large's speech transformer. Its math is ``reference/wavlm.py``
(the forward) and ``reference/pose.py``; it serves only (no training
configuration).

Seeded weights: ``sdt_hubert``'s kinds for what WavLM shares with HuBERT, and
for its own leaves: the bucket embedding N(0, 1), PyTorch's init, which
transformers leaves; the gate's linear N(0, GATE_LINEAR), its bias N(0,
0.02); the constants 1 + GATE_CONST z (WavLM's are 1). At WavLM's N(0, 0.02)
the gate's two sums spread by ~0.3 over the queries, the sigmoids sit near
1/2 and the gate hardly moves with the query; here they spread by 16
GATE_LINEAR = 8, so a query's sigmoids lie near 0 or 1 and its gate is 2, 1
or 1 + c_h, and the constants spread each head's 1 + c_h over a wide range.
Only so does a gate held at its mean over the queries read over the cell's
limits on every seed: the poses take a small and seed-dependent share of a
change of the encoder's output."""

from typing import Callable, Dict, Optional

import torch

from .. import correct
from ..reference import no_tf32
from ..reference import pose as ref_pose
from ..reference import wavlm as ref_wavlm
from . import sdt_hubert

GATE_LINEAR = 0.5  # the gate's linear, N(0, GATE_LINEAR)
GATE_CONST = 16.0  # the gate's constants, 1 + GATE_CONST z
KERNELS = ["in_act", "ln_gelu"]
INIT: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    **sdt_hubert.INIT,
    "rel_embed": lambda z: z,
    "gate_linear": lambda z: GATE_LINEAR * z,
    "gate_const": lambda z: 1.0 + GATE_CONST * z,
}
# the encoder's widths in the configuration, under the published config's keys
WIDTHS = sdt_hubert.WIDTHS + ("conv_bias", "num_buckets", "max_bucket_distance")


def leaves(m: dict) -> list:
    return ref_wavlm.leaves(m)


def port_keys(cfg) -> dict:
    """``sdt_hubert.port_keys`` with WavLM's three keys from the port's table."""
    from speechdrivestemplates_tpu_torch.models import MODELS

    spec = MODELS[cfg.VOICE2POSE.GENERATOR.NAME].SPEC
    return {**sdt_hubert.port_keys(cfg), **{k: getattr(spec, k) for k in WIDTHS[-3:]}}


def port_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``SequenceGeneratorWavLM`` takes the reference's names."""
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
            pred = ref_wavlm.forward(weights, audio[a:a + correct.BLOCK],
                                     num_frames or m["num_frames"], c, m, quant)
            out.append(ref_pose.final_poses(pred, stat, m["hierarchical_pose"]))
    return torch.cat(out)


def _gate_at_its_mean(table, logits, const):
    s = torch.sigmoid(logits.float())
    g = s[..., 0] * (s[..., 1] * const - 1.0) + 2.0
    g = g.mean(dim=1, keepdim=True).expand_as(g)
    return table * g.to(table.dtype).transpose(1, 2)[..., None]


def _fault(name: str, make):
    """A context that swaps the port's ``speech_encoder.<name>`` for
    ``make(original)`` while it is open."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        from speechdrivestemplates_tpu_torch.models import speech_encoder as SE

        original = getattr(SE, name)
        setattr(SE, name, make(original))
        try:
            yield
        finally:
            setattr(SE, name, original)

    return ctx


def _bucket_off_by_one(original):
    def bucket(rel, num_buckets, max_distance):
        half = num_buckets // 2
        out = original(rel, num_buckets, max_distance)
        side = (rel > 0).to(out.dtype) * half
        shifted = torch.clamp(out - side + 1, max=half - 1) + side
        return torch.where(rel.abs() >= half // 2, shifted, out)

    return bucket


# faults of the program that the cell's limits must catch (``calibrate_faults.py``):
# the bias dropped (flash on the card), the gate held at its mean over the
# queries, the log-spaced buckets one too far
FAULTS = {
    "bias_dropped": _fault("attention", lambda f: lambda q, k, v, bias=None, plain=False:
                           f(q, k, v, None, plain)),
    "gate_mean": _fault("gated_bias", lambda f: _gate_at_its_mean),
    "bucket_off_by_one": _fault("relative_position_bucket", _bucket_off_by_one),
}
