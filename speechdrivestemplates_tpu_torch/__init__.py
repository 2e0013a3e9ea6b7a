"""PyTorch / CUDA port of the Speech Drives Templates system for NVIDIA Hopper.

A package of its own beside ``speechdrivestemplates_tpu`` (the JAX reference,
which it never imports). This slice serves the SDT-BP wav -> pose function:

    audio (B, L) f32 -> mel (B, 80, L//160+1)          ops/mel.py   (CUDA kernel)
      -> SequenceGeneratorCNN                          models/      (stem: ops/conv1.py,
                                                                     ops/stem.py: CUDA kernels)
      -> normalized poses (B, T, 2, K)
      -> speaker statistics -> pixel-space poses       ops/pose.py

Entry points run on the card unless the caller passes ``device="cpu"``:
``serving.build_serving_fn``, ``python -m speechdrivestemplates_tpu_torch.serving``
and ``models.build_model``. Two more measure the card:
``python -m speechdrivestemplates_tpu_torch.profile_serving`` (the serving
forward's time by kernel) and ``python -m speechdrivestemplates_tpu_torch.profile_kernels``
(the conv1 kernel and the tap-shift probe, ``ops/shift_probe.py``, beside cuDNN).
"""
