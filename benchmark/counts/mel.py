"""B1, the mel frontend: (B, L) float32 audio -> (B, 80, L // 160 + 1)
float32. Per frame: a real 512-point FFT (2.5 N log2 N), the 400-tap window,
the power of 257 bins (3 each) and the 257 x 80 mel projection (2 each)."""

import math

N_FFT, WIN, HOP, BINS, MELS = 512, 400, 160, 257, 80
FLOPS_PER_FRAME = 2.5 * N_FFT * math.log2(N_FFT) + WIN + 3 * BINS + 2 * BINS * MELS


def frames(samples: int) -> int:
    return samples // HOP + 1


def count(batch: int, samples: int):
    """(operations, bytes) of one call."""
    t = frames(samples)
    return batch * t * FLOPS_PER_FRAME, 4.0 * batch * (samples + MELS * t)
