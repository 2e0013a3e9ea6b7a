"""Operations and bytes of ``SequenceGeneratorHuBERT`` (the speech encoder of
``reference/speech_encoder.py``), functions of the configuration's widths
(``m``) and the clip's samples alone.

Operations: every convolution and matmul at 2 x MACs at its output size; the
attention's two products at 2 x B x T^2 x hidden each, 4 x B x T^2 x hidden a
layer. Norms, GELU, softmax and the residual adds are left out, as
``counts/generator.py`` leaves them out. Bytes: each input byte read once and
each output byte written once, in the compute dtype (``elem`` bytes).
"""

from . import generator


def frames(m: dict, samples: int) -> int:
    """Encoder frames of one clip (213 of 68,267 samples)."""
    for k, s in zip(m["conv_kernel"], m["conv_stride"]):
        samples = (samples - k) // s + 1
    return samples


def conv_macs(m: dict, samples: int) -> list:
    """MACs of the feature encoder's convolutions, in order."""
    out, c_in, n = [], 1, samples
    for c, k, s in zip(m["conv_dim"], m["conv_kernel"], m["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n * c * c_in * k)
        c_in = c
    return out


def layer_linears(m: dict) -> list:
    """(inputs, outputs) of each linear map of one transformer layer: Q, K, V,
    the attention's output, the feed-forward's two."""
    h, inner = m["hidden_size"], m["intermediate_size"]
    return [(h, h)] * 4 + [(h, inner), (inner, h)]


def gemms(m: dict, samples: int) -> list:
    """Every matmul of one clip that is a GEMM on the card, as (rows, inputs,
    outputs, has a bias): the layers' linear maps, the feature projection,
    the glue's Linear to 256 channels, and the resizes done as matmuls (the
    glue's from T to num_frames frames, the UNet's five upsamplings)."""
    t, h = frames(m, samples), m["hidden_size"]
    out = [(t, i, o, True) for i, o in layer_linears(m)] * m["num_hidden_layers"]
    out += [(t, m["conv_dim"][-1], h, True), (t, h, 256, True), (256, t, m["num_frames"], False)]
    n = m["num_frames"]
    while n > m["num_frames"] // 32:  # to e1..e5's lengths from the next one down
        out.append((256, n // 2, n, False))
        n //= 2
    return out


def layer_linear_flops(m: dict, samples: int) -> float:
    """One clip's transformer linear maps alone."""
    t = frames(m, samples)
    return 2.0 * m["num_hidden_layers"] * t * sum(i * o for i, o in layer_linears(m))


def encoder_flops(m: dict, samples: int) -> float:
    """One clip through the encoder: convolutions, projection, positional
    convolution, the layers' linear maps and attention."""
    t, h = frames(m, samples), m["hidden_size"]
    k, g = m["num_conv_pos_embeddings"], m["num_conv_pos_embedding_groups"]
    macs = sum(conv_macs(m, samples)) + t * m["conv_dim"][-1] * h + t * h * (h // g) * k
    return 2.0 * macs + layer_linear_flops(m, samples) + attention_count(m, 1, samples)[0]


def forward_flops(m: dict, samples: int) -> float:
    """One clip through the generator: the encoder, the glue's Linear to 256
    channels, and SDT's UNet and decoder (``counts/generator.py``'s
    convolutions after its audio encoder's eight)."""
    head = generator.conv_macs(samples, m["num_frames"], m["code_dim"],
                               m["num_landmarks"])[len(generator.ENCODER):]
    glue = frames(m, samples) * m["hidden_size"] * 256
    return encoder_flops(m, samples) + 2.0 * (glue + sum(head))


def linear_count(m: dict, batch: int, samples: int, elem: int = 2):
    """(operations, bytes) of one call's GEMMs (``gemms``): each weight (and
    bias) read once, each input read and output written once."""
    flops = nbytes = 0.0
    for rows, c_in, c_out, bias in gemms(m, samples):
        flops += 2.0 * batch * rows * c_in * c_out
        nbytes += elem * (c_in * c_out + (c_out if bias else 0) + batch * rows * (c_in + c_out))
    return flops, nbytes


def attention_count(m: dict, batch: int, samples: int, elem: int = 2):
    """(operations, bytes) of one call's attention: Q, K and V read once and
    the output written once a layer; 4 x B x T^2 x hidden operations a layer."""
    t, h, layers = frames(m, samples), m["hidden_size"], m["num_hidden_layers"]
    return layers * 4.0 * batch * t * t * h, layers * 4.0 * elem * batch * t * h
