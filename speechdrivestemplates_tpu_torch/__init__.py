"""PyTorch / CUDA port of the Speech Drives Templates system for NVIDIA Hopper.

A package of its own beside ``speechdrivestemplates_tpu`` (the JAX reference,
which it never imports). It trains Pose2Pose, SDT-BP and SDT-VAE, tests them,
and serves SDT-BP:

    audio (B, L) f32 -> mel (B, 80, L//160+1)          ops/mel.py   (CUDA kernel)
      -> SequenceGeneratorCNN                          models/      (stem: ops/conv1.py,
                                                                     ops/stem.py: CUDA kernels
                                                                     in eval mode; plain cuDNN
                                                                     under autograd in train mode)
      -> normalized poses (B, T, 2, K)
      -> speaker statistics -> pixel-space poses       ops/pose.py

Training and evaluation (``pipelines/``): ``voice2pose.train_step`` (L1 +
clip-code KL, Adam on the generator and a learned bank, or SDT-VAE's frozen
Pose2Pose bank; the frozen ``PoseSeqEncoder``'s BN drift), ``voice2pose.
eval_step`` (the kernels above in eval mode, the FGD features),
``pose2pose.train_step`` / ``eval_step`` (the VAE whose encoder and bank the
Voice2Pose models take), and ``trainer`` (epochs over
``datasets/gesture_dataset.py``, validation, test runs with FGD, reference-
layout ``.pth`` checkpoints with resume files, resume / pretrain /
auto-resume, preemption, TensorBoard scalars, the train set staged on the
card, and K train steps in one CUDA graph through ``pipelines/graphed.py``, the
capture protocol the serving function's graphs share).

The serving export (``utils/export.py``): ``main --export`` writes the
serving function as a ``torch.export`` artifact whose graph calls the kernels
as ``torch.ops.sdt.*`` (``kernels/ops.py``), and ``run_artifact.py`` serves it
without the model code.

Entry points run on the card unless the caller passes ``device="cpu"``:
``python -m speechdrivestemplates_tpu_torch.main`` (training,
``--test_only``, ``--demo_input`` and ``--export``), ``run_artifact.py``,
``chain_e2e`` (the paper's chain at ``bench_e2e.py``'s budget),
``serving.build_serving_fn``, ``python -m speechdrivestemplates_tpu_torch.serving``
and ``models.build_model``. ``profile_kernels`` measures the conv1 kernel
and the tap-shift probe (``ops/shift_probe.py``) beside cuDNN on the card.
The serving forward and the graphed train step are measured by the
benchmark's cells (``BENCHMARK.json``); under any ``torch.profiler`` session
the port records its own spans (``utils/trace.py``).
"""
