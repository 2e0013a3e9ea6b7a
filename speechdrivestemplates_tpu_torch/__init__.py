"""PyTorch / CUDA port of the Speech Drives Templates system for NVIDIA Hopper.

A package of its own beside ``speechdrivestemplates_tpu`` (the JAX reference,
which it never imports). It trains and serves SDT-BP:

    audio (B, L) f32 -> mel (B, 80, L//160+1)          ops/mel.py   (CUDA kernel)
      -> SequenceGeneratorCNN                          models/      (stem: ops/conv1.py,
                                                                     ops/stem.py: CUDA kernels
                                                                     in eval mode; plain cuDNN
                                                                     under autograd in train mode)
      -> normalized poses (B, T, 2, K)
      -> speaker statistics -> pixel-space poses       ops/pose.py

Training (``pipelines/``): ``voice2pose.train_step`` (L1 + clip-code KL, Adam
on the generator and the code bank, the frozen ``PoseSeqEncoder``'s BN drift)
and ``trainer.train`` (epochs over ``datasets/gesture_dataset.py``, reference-
layout ``.pth`` checkpoints).

Entry points run on the card unless the caller passes ``device="cpu"``:
``python -m speechdrivestemplates_tpu_torch.main`` (training),
``serving.build_serving_fn``, ``python -m speechdrivestemplates_tpu_torch.serving``
and ``models.build_model``. Three more measure the card:
``profile_serving`` and ``profile_train`` (device time by kernel of the
serving forward and of the train step) and ``profile_kernels`` (the conv1
kernel and the tap-shift probe, ``ops/shift_probe.py``, beside cuDNN).
"""
