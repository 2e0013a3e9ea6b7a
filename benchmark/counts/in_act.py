"""An IN generator's eval-mode IN apply after the stem (csrc/in_act.cu: the
statistics, the norm, leaky ReLU and the cast in one pass) over its 21 layers:
the audio encoder's layers 3-7 (2-D) and the UNet's twelve and the decoder's
four 1-D layers, at the shapes of the BN generator's same layers
(counts/bn_act.py). Bytes: each activation element read once and written once
in the compute dtype. Operations: 2 an element, as counts/bn_act.py counts
its apply, so bytes bound it."""

from . import bn_act

STEM_LAYERS = 3  # the audio encoder's first three layers run in the stem kernels


def layer_sizes(mel_frames: int, num_frames: int):
    """(channels, elements a clip) of each IN layer after the stem, in forward order."""
    return bn_act.layer_sizes(mel_frames, num_frames)[STEM_LAYERS:]


def count(batch: int, mel_frames: int, num_frames: int = 64, elem: int = 2):
    """(operations, bytes) of one call's IN layers after the stem."""
    elements = batch * sum(n for _, n in layer_sizes(mel_frames, num_frames))
    return 2.0 * elements, float(2 * elem * elements)
