"""Operations and bytes of ``SequenceGeneratorWavLM`` (the speech encoder of
``reference/wavlm.py``), functions of the configuration's widths and the
clip's samples alone: ``speech_encoder.py``'s counts (the convolutions count
the same without their bias) and the gate's linear map, 2 x head_dim x 8
operations a head, token and layer.

The biased attention's least work is plain attention's
(``speech_encoder.attention_count``): 4 x B x T^2 x hidden operations a
layer, and Q, K, V and O once. The (B, heads, T, T) bias is not counted: a
kernel that computes it from the table and the gate inside the attention
never writes or reads it, and a count that held it would let such a kernel
read over 100%.
"""

from . import speech_encoder

frames = speech_encoder.frames
attention_count = speech_encoder.attention_count


def gate_flops(m: dict, samples: int) -> float:
    """One clip's gate linear maps, over every layer."""
    t, h = frames(m, samples), m["hidden_size"]
    return 2.0 * m["num_hidden_layers"] * t * h * 8


def encoder_flops(m: dict, samples: int) -> float:
    return speech_encoder.encoder_flops(m, samples) + gate_flops(m, samples)


def forward_flops(m: dict, samples: int) -> float:
    return speech_encoder.forward_flops(m, samples) + gate_flops(m, samples)
