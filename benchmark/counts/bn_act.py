"""A BN generator's eval-mode BN apply (csrc/bn_act.cu: the norm, leaky ReLU
and the cast in one pass) over its 24 layers: the audio encoder's eight 2-D
activations and the UNet's twelve and the decoder's four 1-D ones, at 256
channels. Bytes: each activation element read once and written once in the
compute dtype, and each layer's four fp32 vectors. Operations: 2 an element
(the affine as one multiply-add), so bytes bound it."""

from .generator import ENCODER, _out


def layer_sizes(mel_frames: int, num_frames: int):
    """(channels, elements a clip) of each BN layer, in forward order."""
    h, w, out = 80, mel_frames, []
    for _, co, (kh, kw), s, p in ENCODER:
        h, w = _out(h, kh, s, p), _out(w, kw, s, p)
        out.append((co, co * h * w))
    lengths = [num_frames, num_frames]  # e0, e1
    for _ in range(5):                  # e2..e6
        lengths.append(_out(lengths[-1], 4, 2, 1))
    lengths += lengths[5:0:-1]          # d5..d1 at e5..e1's lengths
    lengths += [num_frames] * 4         # decoder.0-3
    return out + [(256, 256 * t) for t in lengths]


def count(batch: int, mel_frames: int, num_frames: int = 64, elem: int = 2):
    """(operations, bytes) of one call's BN layers."""
    sizes = layer_sizes(mel_frames, num_frames)
    elements = batch * sum(n for _, n in sizes)
    return 2.0 * elements, float(2 * elem * elements + 16 * sum(c for c, _ in sizes))
