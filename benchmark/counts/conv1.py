"""B3, the audio encoder's layer 0 (conv 1->64 3x3, IN, leaky ReLU):
(B, 80, W) float32 mel and (64, 1, 3, 3) float32 weights -> (B, 80, W, 64)
activations in the compute dtype (bf16: 2 bytes). The two zero rows of the
kernel's padded layout are its own and are not counted."""

MELS, C_OUT, TAPS = 80, 64, 9


def count(batch: int, width: int, out_bytes: int = 2):
    return (2.0 * batch * MELS * width * C_OUT * TAPS,
            4.0 * batch * MELS * width + 4.0 * C_OUT * TAPS
            + out_bytes * batch * MELS * width * C_OUT)
