"""The speech encoder's feature-encoder norm (csrc/ln_gelu.cu: the
convolution's bias, the LayerNorm over the channels, GELU and the cast in one
pass) over its seven layers, functions of the configuration's widths and the
clip's samples alone. Bytes: each layer's (B, T_i, C_i) output read once and
written once in the compute dtype, and its bias, LayerNorm weight and beta
(3 x C_i) read once. Operations: 2 an element, as counts/in_act.py counts
its apply, so bytes bound it."""


def layer_sizes(m: dict, samples: int) -> list:
    """(channels, elements a clip) of each feature-encoder layer's output, in
    order: (512, 13,652 x 512) down to (512, 213 x 512) at 68,267 samples."""
    out, n = [], samples
    for c, k, s in zip(m["conv_dim"], m["conv_kernel"], m["conv_stride"]):
        n = (n - k) // s + 1
        out.append((c, n * c))
    return out


def count(m: dict, batch: int, samples: int, elem: int = 2):
    """(operations, bytes) of one call's seven feature-encoder norms."""
    sizes = layer_sizes(m, samples)
    elements = batch * sum(n for _, n in sizes)
    params = 3 * sum(c for c, _ in sizes)
    return 2.0 * elements, float(elem * (2 * elements + params))
