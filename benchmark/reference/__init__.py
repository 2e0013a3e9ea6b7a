"""The plain float32 reference of the benchmark's configurations.

Plain PyTorch, written from the published model (Qian et al., Speech Drives
Templates, ICCV 2021; the reference repository's ``SequenceGeneratorCNN``),
independent of the code under test: it imports neither JAX, the JAX package
nor anything of ``speechdrivestemplates_tpu_torch``. It takes the benchmark's
seeded weights, codes, audio and train set by the reference repository's
parameter names, and works out everything else again: the mel spectrogram
(``torch.stft``), the resizes (``F.interpolate``), the norms, the pose
transform, the losses and Adam. ``no_tf32`` keeps every float32 matmul and
convolution in float32 on the card.
"""

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
