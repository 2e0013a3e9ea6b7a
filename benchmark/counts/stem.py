"""B2, the audio encoder's layers 1-2 (conv 64->64 4x4 stride 2, IN, leaky
ReLU; conv 64->128 3x3, IN, leaky ReLU) in bf16: (B, 80, W, 64) in, weights
(64, 64, 4, 4) and (128, 64, 3, 3), (B, 40, W2, 128) out,
W2 = (W - 2) // 2 + 1."""

MELS, C1, C3 = 80, 64, 128


def dims(width: int):
    return (MELS - 2) // 2 + 1, (width - 2) // 2 + 1


def count(batch: int, width: int, elem: int = 2):
    h2, w2 = dims(width)
    macs = batch * h2 * w2 * (C1 * C1 * 16 + C3 * C1 * 9)
    nbytes = elem * (batch * MELS * width * C1 + C1 * C1 * 16 + C3 * C1 * 9
                     + batch * h2 * w2 * C3)
    return 2.0 * macs, float(nbytes)
