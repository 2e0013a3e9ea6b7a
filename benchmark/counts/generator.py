"""Model operations of one clip through ``SequenceGeneratorCNN``: every
convolution at 2 x MACs at its output size, plus the mel's FFT count; the
train step adds each convolution's backward (data and weight gradients, 2 x
the forward; layer 0 has no data gradient, the mel takes none) and the frozen
``PoseSeqEncoder``'s forward on the prediction and on the ground truth.
Norms, activations, resizes and the losses are left out: they are not
operations a faster implementation could be credited for removing."""

from . import mel

# audio encoder: (C_in, C_out, (kh, kw), stride, padding), as the published model
ENCODER = [(1, 64, (3, 3), 1, 1), (64, 64, (4, 4), 2, 1), (64, 128, (3, 3), 1, 1),
           (128, 128, (4, 4), 2, 1), (128, 256, (3, 3), 1, 1), (256, 256, (4, 4), 2, 1),
           (256, 256, (3, 3), 1, 1), (256, 256, (6, 3), 1, 0)]
# PoseSeqEncoder: (C_out, downsample) after 2K input channels
POSE_ENCODER = [(256, False)] * 2 + [(256, True)] * 4 + [(64, True)]


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def conv_macs(samples: int, num_frames: int, code_dim, num_landmarks: int):
    """MACs of every convolution of the generator's forward, in order."""
    h, w = 80, mel.frames(samples)
    out = []
    for ci, co, (kh, kw), s, p in ENCODER:
        h, w = _out(h, kh, s, p), _out(w, kw, s, p)
        out.append(h * w * co * ci * kh * kw)
    t = num_frames
    c_in = 256 + (code_dim or 0)
    lengths = [t]
    out.append(t * 256 * c_in * 3)  # e0
    out.append(t * 256 * 256 * 3)   # e1
    for _ in range(5):              # e2..e6
        t = _out(t, 4, 2, 1)
        lengths.append(t)
        out.append(t * 256 * 256 * 4)
    for t in reversed(lengths[:5]):  # d5..d1 at e5..e1's lengths
        out.append(t * 256 * 256 * 3)
    out += [num_frames * 256 * 256 * 3] * 4             # decoder.0-3
    out.append(num_frames * 2 * num_landmarks * 256)     # decoder.4
    return out


def pose_encoder_macs(num_frames: int, num_landmarks: int) -> int:
    t, c_in, total = num_frames, 2 * num_landmarks, 0
    for co, down in POSE_ENCODER:
        k = 4 if down else 3
        t = _out(t, k, 2 if down else 1, 1)
        total += t * co * c_in * k
        c_in = co
    return total


def forward_flops(samples: int, num_frames: int, code_dim, num_landmarks: int) -> float:
    macs = conv_macs(samples, num_frames, code_dim, num_landmarks)
    return 2.0 * sum(macs) + mel.count(1, samples)[0]


def train_step_flops(samples: int, num_frames: int, code_dim, num_landmarks: int) -> float:
    macs = conv_macs(samples, num_frames, code_dim, num_landmarks)
    backward = 2.0 * (2 * sum(macs) - macs[0])
    return (forward_flops(samples, num_frames, code_dim, num_landmarks) + backward
            + 2 * 2.0 * pose_encoder_macs(num_frames, num_landmarks))
