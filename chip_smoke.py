#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device   a CUDA device is present; its name and power limit are printed
  2. build    the CUDA kernels compile from speechdrivestemplates_tpu_torch/csrc
  3. mel      the fused STFT+mel kernel vs its plain PyTorch version at (128, 68267), on
              a normal input and on one with 60 dB between its loud and quiet halves,
              whose quiet frames are also held relatively
  4. conv1    the fused conv1+IN1 kernel vs its plain version at (128, 80, 427): fp32
              at rtol/atol 2e-5 on a normal mel and on one offset by 100 (where fp32
              moments would lose digits), zero rows 0 and 81, bf16 within 2e-2 mean
              relative error
  5. stem     the stem (conv1 kernel, then the fused stem kernel) vs its plain version at
              (128, 80, 427), in fp32 (tight tolerance) and in bf16 (the serving dtype);
              the stem kernel alone vs its plain version on one activation, its fp32
              path at the tight tolerance and its bf16 path against the plain bf16 tail
  6. shift    the tap-shift probe kernel, aligned and subtile, vs its plain version at
              (128, 4480, C) x (9, C, C) for C = 64 and 128, within one bf16 rounding
  7. serve    SDT-BP, bf16, full width, seeded weights: three requests (B = 1, 16, 128)
              through build_serving_fn; the mel, conv1 and stem launch counters must read
              1, 2, 3 after the requests; the B=128 result is held to an fp32 all-plain
              forward
  8. cli      the serving command line on a seeded wav and a reference-layout .pth
  9. probe    the kernel-probe command line (profile_kernels, both probes) in a
              subprocess: rc 0, its JSON line, both of its kernels launched
 10. train    SDT-BP bf16 training at full width, B = 32, on a synthetic speaker of 64
              clips written under build/chip_smoke/: the mel kernel vs its plain
              version on a train batch's audio (32, 68266), with phase 3's gates; one
              step launches the mel kernel once and neither conv1 nor the stem (train
              mode runs the plain stem under autograd), and the stem's weights get
              gradients; at the pre-step weights the bf16 step's G_reg_loss is within
              2% of an fp32 all-plain step's and the two generator gradients have a
              cosine >= 0.99; 30 steps at LR 1e-3 keep every loss finite and bring the
              mean G_reg_loss of the last 4 below that of the first 4; the step's time
              by CUDA events over 20 steps on device-resident batches, and the trainer
              loop's steps/s with its loader over two 50-step epochs of a 1,600-clip
              speaker, and the loader's batches/s alone over a third
 11. train-cli  `python -m speechdrivestemplates_tpu_torch.main --device cuda` for two
              epochs in a subprocess: rc 0, a JSON line naming a checkpoint, and the
              serving command line serves a wav from that checkpoint
Then one JSON line with every kernel's error, times, bound and launches (the mel
kernel's count over the serving requests and the train phase's steps), the card's
name and power limit, a JSON line with the train step's time, and last
{"ok": true, "device": {...}}.

Times are CUDA-event means over repeated calls after a warm-up; inputs rotate over
three copies so that each call reads from device memory rather than the 50 MB L2.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import wave

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet): bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from speechdrivestemplates_tpu_torch import kernels
    from speechdrivestemplates_tpu_torch.config import sdt_bp
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.ops import conv1 as C1
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops import shift_probe as SP
    from speechdrivestemplates_tpu_torch.ops import stem as S
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn
    from speechdrivestemplates_tpu_torch.utils.timing import card as card_line
    from speechdrivestemplates_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    # reference arithmetic in full fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)

    # ---- 1. device ---------------------------------------------------------------
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}", flush=True)

    # ---- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all()
    for name in kernels.SIGNATURES:
        kernels.library(name)
    print(f"[build] {sorted(kernels.SIGNATURES)} in {time.perf_counter() - t0:.2f} s "
          f"(compiled now: {built})", flush=True)

    def dev_randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    report = {}

    # ---- 3. mel kernel -----------------------------------------------------------
    def check_mel(audio, what):
        """B1 against its plain version on ``audio`` and on a copy whose second
        half is 60 dB quieter. The kernel's three-pass bf16 split keeps ~2^-16
        relative: the gate of tests/test_mel_pallas.py. The quiet half's mel
        values sit far below atol, so the frames whose window (samples
        160 t - 200 .. 160 t + 199) lies wholly inside it are also held
        relatively, on the bins above 1e-3 of their largest. Returns the max abs
        error, the quiet frames' max rel error and their first frame."""
        b, n = audio.shape
        wide = audio.clone()
        wide[:, n // 2:] *= 1e-3
        t_quiet = -(-(n // 2 + 200) // 160)
        err = 0.0
        for name, a in (("normal", audio), ("60 dB", wide)):
            k = M.mel_spectrogram_kernel(a)
            p = M.mel_spectrogram_plain(a)
            torch.cuda.synchronize()
            check(k.shape == p.shape == (b, 80, n // 160 + 1), f"mel shape {tuple(k.shape)}")
            e = (k - p).abs().max().item()
            check(torch.allclose(k, p, rtol=1e-3, atol=1e-4),
                  f"mel kernel vs plain ({what}, {name} input): max abs err {e}")
            err = max(err, e)
        q = p[..., t_quiet:]
        sel = q > 1e-3 * q.max()
        quiet_rel = ((k[..., t_quiet:] - q).abs()[sel] / q[sel]).max().item()
        check(quiet_rel <= 1e-3,
              f"mel kernel vs plain on the quiet half ({what}): max rel err {quiet_rel}")
        return err, quiet_rel, t_quiet

    B, L = 128, 68267
    T = L // 160 + 1
    audios = [dev_randn(B, L, scale=0.1) for _ in range(3)]
    mel_err, quiet_rel, t_quiet = check_mel(audios[0], f"({B}, {L})")
    fb = torch.from_numpy(M._mel_filterbank_np(16000, 512, 80, 55.0, 7500.0)).to(dev)
    hann = torch.hann_window(400, periodic=True, device=dev)

    def mel_library(a):
        spec = torch.stft(a, 512, 160, 400, hann, center=True, pad_mode="reflect",
                          return_complex=True)
        return fb.T @ (spec.real ** 2 + spec.imag ** 2)

    check(torch.allclose(mel_library(audios[0]), M.mel_spectrogram_plain(audios[0]),
                         rtol=1e-3, atol=1e-4),
          "torch.stft yardstick disagrees with the plain mel")
    # the DFT (400 taps x 512 columns) and the mel projection (256 x 80) on the
    # tensor cores, three bf16 passes each
    n_frames = B * T
    mel_b, mel_by = bound_ms(4.0 * (B * L + B * 80 * T),
                             3 * 2.0 * n_frames * (400 * 512 + 256 * 80), "bf16")
    report["mel"] = dict(
        name="mel_stft_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/mel.cu",
        replaces="speechdrivestemplates_tpu/ops/mel_pallas.py:123",
        max_abs_err=mel_err,
        ms=cuda_ms(M.mel_spectrogram_kernel, [(a,) for a in audios]),
        plain_ms=cuda_ms(M.mel_spectrogram_plain, [(a,) for a in audios]),
        bound_ms=mel_b, bound_by=mel_by,
        library_ms=cuda_ms(mel_library, [(a,) for a in audios]))
    print(f"[mel] (128, 68267) normal and 60 dB inputs: max abs err {mel_err:.3e} "
          f"(rtol 1e-3, atol 1e-4); quiet half of the 60 dB input (frames {t_quiet}-{T - 1}): "
          f"max rel err {quiet_rel:.3e} (rtol 1e-3); "
          f"kernel {report['mel']['ms']:.4f} ms, plain {report['mel']['plain_ms']:.4f} ms, "
          f"torch.stft {report['mel']['library_ms']:.4f} ms, bound {mel_b:.4f} ms "
          f"({mel_by})", flush=True)

    # ---- 4. conv1 kernel ---------------------------------------------------------
    bf = torch.bfloat16
    W1 = T
    mels = [dev_randn(B, 80, W1) for _ in range(3)]
    w1, w2, w3 = dev_randn(64, 1, 3, 3, scale=0.2), dev_randn(64, 64, 4, 4, scale=0.05), \
        dev_randn(128, 64, 3, 3, scale=0.05)
    ref1 = C1.conv1_in_plain(mels[0], w1, 0.2, torch.float32)
    k1 = C1.conv1_in_kernel(mels[0], w1, 0.2, torch.float32)
    k1b = C1.conv1_in_kernel(mels[0], w1, 0.2, bf)
    torch.cuda.synchronize()
    check(k1.shape == ref1.shape == k1b.shape == (B, C1.ROWS, W1, 64),
          f"conv1 shape {tuple(k1.shape)}")
    conv1_err = (k1 - ref1).abs().max().item()
    # fp32 FMAs of the same operands on both sides; the statistics are summed in
    # another order: the gate of tests/test_conv1_pallas.py
    check(torch.allclose(k1, ref1, rtol=2e-5, atol=2e-5),
          f"conv1 fp32 kernel vs plain: max abs err {conv1_err}")
    for t in (k1, k1b):
        check(not t[:, 0].any() and not t[:, -1].any(), "conv1 rows 0 and 81 are not zero")
    conv1_rel16 = ((k1b.float() - ref1).abs().mean() / ref1.abs().mean()).item()
    check(conv1_rel16 < 2e-2, f"conv1 bf16 kernel vs fp32 plain: mean rel err {conv1_rel16}")
    # a mel at a large constant offset, where fp32 moments E[y^2] - E[y]^2 would
    # lose digits: the kernel's fp64 Gram statistics hold the same fp32 gate
    offset_mel = mels[0] + 100.0
    ref1 = C1.conv1_in_plain(offset_mel, w1, 0.2, torch.float32)
    k1 = C1.conv1_in_kernel(offset_mel, w1, 0.2, torch.float32)
    torch.cuda.synchronize()
    offset_err = (k1 - ref1).abs().max().item()
    check(torch.allclose(k1, ref1, rtol=2e-5, atol=2e-5),
          f"conv1 fp32 kernel vs plain on the offset mel: max abs err {offset_err}")
    check(not k1[:, 0].any() and not k1[:, -1].any(), "conv1 rows 0 and 81 are not zero")
    conv1_err = max(conv1_err, offset_err)
    del ref1, k1, k1b, offset_mel

    def conv1_library(mel):
        x = F.conv2d(mel[:, None].to(bf), w1.to(bf), padding=1)
        return F.leaky_relu(F.instance_norm(x), 0.2)

    conv1_b, conv1_by = bound_ms(4.0 * B * 80 * W1 + 4.0 * w1.numel() + 2.0 * B * C1.ROWS * W1 * 64,
                                 2.0 * B * 80 * W1 * 64 * 9, "fp32")
    conv1_args = [(m, w1, 0.2, bf) for m in mels]
    report["conv1"] = dict(
        name="conv1_in_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/conv1.cu",
        replaces="probes/conv1_pallas.py:117",
        max_abs_err=conv1_err,
        ms=cuda_ms(C1.conv1_in_kernel, conv1_args),
        plain_ms=cuda_ms(C1.conv1_in_plain, conv1_args, 5),
        bound_ms=conv1_b, bound_by=conv1_by,
        library_ms=cuda_ms(conv1_library, [(m,) for m in mels]))
    print(f"[conv1] (128, 80, {W1}) fp32 max abs err {conv1_err:.3e} (rtol 2e-5, atol 2e-5) "
          f"over a normal mel and one offset by 100 ({offset_err:.3e} there); "
          f"rows 0 and 81 zero; bf16 mean rel err {conv1_rel16:.3e} (< 2e-2); bf16 kernel "
          f"{report['conv1']['ms']:.4f} ms, plain {report['conv1']['plain_ms']:.4f} ms, cuDNN "
          f"conv1+IN+lrelu {report['conv1']['library_ms']:.4f} ms, bound {conv1_b:.4f} ms "
          f"({conv1_by})", flush=True)

    # ---- 5. stem: conv1 kernel + stem kernel ---------------------------------------
    H2, W2 = S.stem_dims(W1)
    ref32 = S.stem_plain(mels[0], w1, w2, w3, 0.2, torch.float32)
    k32 = S.stem_kernel(mels[0], w1, w2, w3, 0.2, torch.float32)
    torch.cuda.synchronize()
    check(k32.shape == ref32.shape == (B, H2, W2, 128), f"stem shape {tuple(k32.shape)}")
    whole_err = (k32 - ref32).abs().max().item()
    # both sides accumulate fp32 products of the same operands (no TF32): they differ
    # by summation order only, ~1e-6 relative on O(1) post-norm values
    check(torch.allclose(k32, ref32, rtol=2e-4, atol=2e-5),
          f"stem fp32 kernels vs plain: max abs err {whole_err}")
    k16 = S.stem_kernel(mels[0], w1, w2, w3, 0.2, bf).float()
    err16 = (k16 - ref32).abs().flatten()
    q99 = torch.quantile(err16[:: max(1, err16.numel() // 4_000_000)], 0.99).item()
    check(q99 < 0.05 and err16.mean().item() < 0.02,
          f"stem bf16 kernels vs fp32 plain: p99 {q99}, mean {err16.mean().item()}")
    del ref32, k32, k16, err16
    # the stem kernel alone, on one conv1 activation: first its fp32 path (the
    # CUDA-core kernel, kept for the tight gate), then the served bf16 path
    # (wgmma, bf16 y2 and y3) against the plain tail in bf16
    y1 = C1.conv1_in_plain(mels[0], w1, 0.2, torch.float32)
    t32 = S.stem_tail_kernel(y1, w2, w3, 0.2, torch.float32)
    tref = S.stem_tail_plain(y1, w2, w3, 0.2, torch.float32)
    torch.cuda.synchronize()
    fp32_err = (t32 - tref).abs().max().item()
    check(torch.allclose(t32, tref, rtol=2e-4, atol=2e-5),
          f"stem kernel fp32 path vs plain on one activation: max abs err {fp32_err}")
    del y1, t32, tref
    y1s = [C1.conv1_in_kernel(m, w1, 0.2, bf) for m in mels]
    t16 = S.stem_tail_kernel(y1s[0], w2, w3, 0.2, bf)
    tref = S.stem_tail_plain(y1s[0], w2, w3, 0.2, bf)
    torch.cuda.synchronize()
    check(t16.shape == tref.shape == (B, H2, W2, 128) and t16.dtype == bf,
          f"stem kernel bf16 shape {tuple(t16.shape)} {t16.dtype}")
    e16 = (t16.float() - tref.float()).abs().flatten()
    stem_err = e16.max().item()
    tail_q99 = torch.quantile(e16[:: max(1, e16.numel() // 4_000_000)], 0.99).item()
    # bf16 roundings of y2, y3 and the output in another order: a few bf16 ulps of
    # the O(1) post-norm values at most (one ulp is 2^-5 at 4)
    check(tail_q99 < 0.05 and e16.mean().item() < 0.02 and stem_err < 0.1,
          f"stem kernel bf16 vs plain bf16 on one activation: p99 {tail_q99}, "
          f"mean {e16.mean().item()}, max abs err {stem_err}")
    del t16, tref, e16
    w2b, w3b = w2.to(bf), w3.to(bf)

    def stem_library(y1):
        x = F.conv2d(y1.permute(0, 3, 1, 2), w2b, stride=2, padding=(0, 1))
        x = F.leaky_relu(F.instance_norm(x), 0.2)
        x = F.conv2d(x, w3b, padding=1)
        return F.leaky_relu(F.instance_norm(x), 0.2)

    # the stem kernel's work: conv2 + conv3 on the 80 data rows of the activation
    stem_flops = 2.0 * B * H2 * W2 * (64 * 64 * 16 + 128 * 64 * 9)
    stem_bytes = 2.0 * B * 80 * W1 * 64 + 2.0 * (w2.numel() + w3.numel()) \
        + 2.0 * B * H2 * W2 * 128
    stem_b, stem_by = bound_ms(stem_bytes, stem_flops, "bf16")
    tail_args = [(y, w2, w3, 0.2, bf) for y in y1s]
    report["stem"] = dict(
        name="audio_encoder_stem_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/stem.cu",
        replaces="probes/stem_pallas.py:192",
        max_abs_err=stem_err,
        ms=cuda_ms(S.stem_tail_kernel, tail_args, 10),
        plain_ms=cuda_ms(S.stem_tail_plain, tail_args, 10),
        bound_ms=stem_b, bound_by=stem_by,
        library_ms=cuda_ms(stem_library, [(y,) for y in y1s], 10))
    whole_ms = cuda_ms(S.stem_kernel, [(m, w1, w2, w3, 0.2, bf) for m in mels], 10)
    print(f"[stem] (128, 80, {W1}) conv1+stem kernels fp32 max abs err {whole_err:.3e} "
          f"(rtol 2e-4, atol 2e-5), bf16 vs fp32 p99 {q99:.4f} (< 0.05); stem kernel alone: "
          f"fp32 path (CUDA cores) max abs err {fp32_err:.3e} (rtol 2e-4, atol 2e-5), bf16 "
          f"path (wgmma) vs plain bf16 max abs err {stem_err:.3e} (< 0.1), p99 {tail_q99:.4f} "
          f"(< 0.05); bf16 stem kernel {report['stem']['ms']:.4f} ms, "
          f"plain {report['stem']['plain_ms']:.4f} ms, cuDNN {report['stem']['library_ms']:.4f} "
          f"ms, bound {stem_b:.4f} ms ({stem_by}); whole stem (conv1 + stem kernels) "
          f"{whole_ms:.4f} ms", flush=True)
    del mels, audios, y1s

    # ---- 6. shift-probe kernel ------------------------------------------------------
    # C = 128 (a 2-CTA cluster) for the kernels line, and C = 64 (one CTA)
    NP, MP = 128, 4480
    MP_out = MP - 2 * 224
    shift_ms, shift_err = {}, 0.0
    for CP in (64, 128):
        xs = [dev_randn(NP, MP, CP, scale=0.1).to(bf) for _ in range(3)]
        wsh = dev_randn(9, CP, CP, scale=0.05).to(bf)
        for mode in SP.MODES:
            ks = SP.shift_taps_kernel(xs[0], wsh, MP_out, mode)
            ps = SP.shift_taps_plain(xs[0], wsh, MP_out, mode)
            torch.cuda.synchronize()
            check(ks.shape == ps.shape == (NP, MP_out, CP) and ks.dtype == bf,
                  f"shift C={CP} {mode} shape {tuple(ks.shape)} {ks.dtype}")
            err = (ks.float() - ps.float()).abs().max().item()
            # the same fp32 sums in another order, each cast to bf16: one rounding apart
            check(torch.allclose(ks.float(), ps.float(), rtol=1e-2, atol=1e-3),
                  f"shift C={CP} {mode} kernel vs plain: max abs err {err}")
            shift_err = max(shift_err, err)
            shift_ms[(CP, mode)] = cuda_ms(SP.shift_taps_kernel,
                                           [(x, wsh, MP_out, mode) for x in xs])
            del ks, ps
    CP = 128  # xs and wsh are C = 128's now
    w_conv = wsh.permute(2, 1, 0).contiguous()

    def shift_library(x):
        return F.conv1d(x[:, :MP_out + 8].transpose(1, 2), w_conv)

    shift_b, shift_by = bound_ms(2.0 * (NP * MP * CP + wsh.numel() + NP * MP_out * CP),
                                 2.0 * NP * MP_out * CP * CP * 9, "bf16")
    report["shift_probe"] = dict(
        name="shift_taps_probe", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/shift_probe.cu",
        replaces="bench_profile.py:523",
        max_abs_err=shift_err,
        ms=shift_ms[(128, "subtile")],
        plain_ms=cuda_ms(SP.shift_taps_plain, [(x, wsh, MP_out, "subtile") for x in xs], 5),
        bound_ms=shift_b, bound_by=shift_by,
        library_ms=cuda_ms(shift_library, [(x,) for x in xs]))
    print(f"[shift] ({NP}, {MP}, C) x (9, C, C), C = 64 and 128, aligned and subtile: max abs "
          f"err {shift_err:.3e} (rtol 1e-2, atol 1e-3); kernel C=128 aligned "
          f"{shift_ms[(128, 'aligned')]:.4f} ms, subtile {shift_ms[(128, 'subtile')]:.4f} ms; "
          f"C=64 aligned {shift_ms[(64, 'aligned')]:.4f} ms, subtile "
          f"{shift_ms[(64, 'subtile')]:.4f} ms; C=128 plain "
          f"{report['shift_probe']['plain_ms']:.4f} ms, cuDNN conv1d "
          f"{report['shift_probe']['library_ms']:.4f} ms, bound {shift_b:.4f} ms ({shift_by})",
          flush=True)
    del xs

    # ---- 7. serving --------------------------------------------------------------
    cfg = sdt_bp(speaker="oliver", precision="bf16")
    sd = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()
    fn, has_code = build_serving_fn(cfg, sd, device="cuda")
    check(has_code, "SDT-BP takes a template code")
    requests = [(dev_randn(b, L, scale=0.1), dev_randn(b, 32)) for b in (1, 16, 128)]
    kernels.reset_launch_counts()
    seen = []
    for audio, code in requests:
        poses = fn(audio, code)
        torch.cuda.synchronize()
        b = audio.shape[0]
        check(poses.shape == (b, 64, 2, 121), f"poses shape {tuple(poses.shape)}")
        check(bool(torch.isfinite(poses).all()), f"non-finite poses at B={b}")
        seen.append(dict(kernels.LAUNCHES))
    launches = dict(kernels.LAUNCHES)
    growth = {name: [s.get(name, 0) for s in seen] for name in ("mel", "conv1", "stem")}
    for name, counts in growth.items():
        check(counts == [1, 2, 3], f"{name} kernel launches per request: {counts}")
        report[name]["launches"] = launches[name]

    audio, code = requests[-1]
    model16 = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device="cuda")
    model16.load_state_dict(sd)
    cfg32 = sdt_bp(speaker="oliver", precision="fp32")
    model32 = build_model(cfg32.VOICE2POSE.GENERATOR.NAME, cfg32, device="cuda")
    model32.load_state_dict(sd)
    with torch.inference_mode():
        out16 = model16(M.mel_spectrogram(audio), 64, code).double()
        out32 = model32(M.mel_spectrogram_plain(audio), 64, code, plain=True).double()
    rel_l2 = (torch.linalg.norm(out16 - out32) / torch.linalg.norm(out32)).item()
    corr = torch.corrcoef(torch.stack([out16.flatten(), out32.flatten()]))[0, 1].item()
    check(rel_l2 < 0.05 and corr > 0.999,
          f"bf16 kernel path vs fp32 plain forward: rel L2 {rel_l2}, corr {corr}")
    fwd_ms = cuda_ms(fn, [requests[-1]], 20)
    fps = 128 * 64 / (fwd_ms / 1e3)
    print(f"[serve] SDT-BP bf16 B=1,16,128 ok; launch counts after each request "
          f"{growth}; B=128 vs fp32 plain: "
          f"rel L2 {rel_l2:.4e}, corr {corr:.6f}; forward {fwd_ms:.4f} ms = "
          f"{fps:.1f} pose-frames/s", flush=True)
    del model16, model32, out16, out32

    # ---- 8. command line ---------------------------------------------------------
    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    ckpt, wav_path, out = (os.path.join(work, f) for f in ("sdt_bp.pth", "in.wav", "out.npz"))
    torch.save({"epoch": 0, "step": 0,
                "model_state_dict": {"module.netG." + k: v for k, v in sd.items()}}, ckpt)
    pcm = (rng.randn(50000) * 3000).astype(np.int16)
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.serving",
                        ckpt, wav_path, out, "--code-seed", "3", "--device", "cuda"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"serving CLI rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    buf = np.zeros((1, L), np.float32)
    buf[0, :50000] = pcm.astype(np.float32) / 32768.0
    expect = fn(buf, np.random.RandomState(3).randn(1, 32).astype(np.float32))[0]
    with np.load(out) as z:
        got = torch.from_numpy(z["poses"]).to(dev)
    check(got.shape == (64, 2, 121) and bool(torch.isfinite(got).all()),
          f"CLI poses {tuple(got.shape)}")
    cli_rel = (torch.linalg.norm(got - expect) / torch.linalg.norm(expect)).item()
    check(cli_rel < 1e-3, f"CLI output differs from in-process serving: rel L2 {cli_rel}")
    print(f"[cli] {r.stdout.strip()}; rel L2 vs in-process {cli_rel:.3e}", flush=True)

    # ---- 9. kernel probes --------------------------------------------------------
    # the probe entry point resets the launch counts as it starts and reports them
    # as it ends, in its last line
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.profile_kernels",
                        "--conv1-probe", "--shift-probe"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"profile_kernels rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    probe = json.loads(r.stdout.strip().splitlines()[-1])
    check("conv1_probe" in probe and "shift_probe" in probe, f"probe line: {probe}")
    for name in ("conv1", "shift_probe"):
        check(probe["launches"].get(name, 0) > 0,
              f"the probes launched no {name} kernel: {probe['launches']}")
    report["shift_probe"]["launches"] = probe["launches"]["shift_probe"]
    print(f"[probe] profile_kernels rc 0; conv1 probe {probe['conv1_probe']['ms']}, "
          f"rel diff {probe['conv1_probe']['rel_diff_layer1']:.3e}; shift probe "
          f"{probe['shift_probe']['ms']}; launches {probe['launches']}", flush=True)

    # ---- 10. train ----------------------------------------------------------------
    from speechdrivestemplates_tpu_torch.config import apply_overrides
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker
    from speechdrivestemplates_tpu_torch.pipelines.trainer import train_epoch, train_loader
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (
        Voice2PoseTrainState, train_step)

    root = os.path.join(work, "speakers")
    shutil.rmtree(root, ignore_errors=True)
    make_synthetic_speaker(root, "oliver", num_train=64, num_dev=0)
    opts = ["DATASET.ROOT_DIR", root, "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"]
    tcfg = apply_overrides(sdt_bp(), list(opts))  # bf16, TRAIN.BATCH_SIZE 32
    loader = train_loader(tcfg)
    TB = tcfg.TRAIN.BATCH_SIZE
    check(TB == 32 and len(loader) == 2, f"train loader: {len(loader)} batches of {TB}")
    loader.batch_sampler.set_epoch(1)
    batches = list(loader)
    state = Voice2PoseTrainState(tcfg, len(loader.dataset), dev)

    # B1 at the train step's shape, (32, 68266): an even L puts each sample at
    # another byte alignment and the last frame's reflect padding elsewhere
    # than phase 3's (128, 68267); these comparison launches are not counted
    TL = batches[0]["audio"].shape[-1]
    train_mel_err, train_quiet_rel, _ = check_mel(batches[0]["audio"].to(dev),
                                                  f"train batch ({TB}, {TL})")
    report["mel"]["max_abs_err"] = max(report["mel"]["max_abs_err"], train_mel_err)

    kernels.reset_launch_counts()
    losses, _ = train_step(state, batches[0])
    torch.cuda.synchronize()
    one_step = dict(kernels.LAUNCHES)
    check({n: one_step.get(n, 0) for n in ("mel", "conv1", "stem")}
          == {"mel": 1, "conv1": 0, "stem": 0},
          f"one train step launched {one_step}: expected mel 1, conv1 0, stem 0")
    stem_grads = [m.conv.weight.grad for m in state.generator.audio_encoder.layers()[:3]]
    check(all(g is not None and bool(torch.isfinite(g).all()) and g.abs().sum() > 0
              for g in stem_grads), "the stem's weights got no gradient in train mode")
    grads16 = torch.cat([p.grad.float().flatten() for p in state.generator.parameters()])
    reg16 = losses["G_reg_loss"].item()

    # the same step at the same seeded weights in fp32, all plain (no TF32)
    cfg32 = apply_overrides(sdt_bp(precision="fp32"), list(opts))
    state32 = Voice2PoseTrainState(cfg32, len(loader.dataset), dev)
    losses32, _ = train_step(state32, batches[0], plain=True)
    torch.cuda.synchronize()
    check(dict(kernels.LAUNCHES) == one_step, "the all-plain fp32 step launched a kernel")
    grads32 = torch.cat([p.grad.flatten() for p in state32.generator.parameters()])
    reg32 = losses32["G_reg_loss"].item()
    reg_rel = abs(reg16 - reg32) / abs(reg32)
    grad_cos = torch.nn.functional.cosine_similarity(grads16.double(), grads32.double(),
                                                     dim=0).item()
    check(reg_rel <= 0.02 and grad_cos >= 0.99,
          f"bf16 step vs fp32 all-plain step: G_reg_loss {reg16} vs {reg32} (rel {reg_rel}), "
          f"gradient cosine {grad_cos}")
    del state, state32, grads16, grads32, stem_grads

    # learning: 30 steps at LR 1e-3 through the loader
    lcfg = apply_overrides(sdt_bp(), opts + ["TRAIN.LR", "1e-3"])
    state = Voice2PoseTrainState(lcfg, len(loader.dataset), dev)
    history, epoch = [], 0
    while len(history) < 30:
        epoch += 1
        loader.batch_sampler.set_epoch(epoch)
        for b in loader:
            step_losses, _ = train_step(state, b)
            history.append(torch.stack(list(step_losses.values())))
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    check(train_launches.get("mel", 0) == 1 + len(history) and not train_launches.get("conv1")
          and not train_launches.get("stem"),
          f"train phase launches {train_launches} over {1 + len(history)} kernel-path steps")
    hist = torch.stack(history).cpu()
    names = list(step_losses)
    check(bool(torch.isfinite(hist).all()), f"non-finite training losses: {hist}")
    reg = hist[:, names.index("G_reg_loss")].tolist()
    first4, last4 = sum(reg[:4]) / 4, sum(reg[-4:]) / 4
    check(last4 < first4, f"G_reg_loss did not fall over {len(reg)} steps: first 4 mean "
                          f"{first4}, last 4 mean {last4}")
    report["mel"]["launches"] += train_launches["mel"]

    # the step on device-resident batches, loader excluded
    def to_dev(x):
        return {k: to_dev(v) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    dev_batches = [(to_dev(b),) for b in batches]
    step_ms = cuda_ms(lambda b: train_step(state, b), dev_batches, 20)
    del state, dev_batches, batches

    # the trainer loop with its loader over long epochs: a speaker of 1,600
    # clips (50 steps an epoch), two epochs on one persistent worker pool; the
    # first epoch starts the workers, the second runs on a warm pool
    long_root = os.path.join(work, "speakers_long")
    shutil.rmtree(long_root, ignore_errors=True)
    make_synthetic_speaker(long_root, "oliver", num_train=50 * TB, num_dev=0)
    long_cfg = apply_overrides(sdt_bp(), ["DATASET.ROOT_DIR", long_root,
                                          "TRAIN.VALIDATE", "False", "TRAIN.SAVE_VIDEO", "False"])
    long_loader = train_loader(long_cfg)
    state = Voice2PoseTrainState(long_cfg, len(long_loader.dataset), dev)
    loop_rates = []
    for e in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = train_epoch(state, long_loader, e)[0]
        torch.cuda.synchronize()
        loop_rates.append(steps / (time.perf_counter() - t0))
    check(steps == 50, f"long epoch: {steps} steps")
    # the loader alone on the same warm pool: a third epoch's batches copied to
    # the card, no train step
    long_loader.batch_sampler.set_epoch(3)
    torch.cuda.synchronize()
    t0, fetched = time.perf_counter(), 0
    for b in long_loader:
        to_dev(b)
        fetched += 1
    torch.cuda.synchronize()
    loader_rate = fetched / (time.perf_counter() - t0)
    workers = long_cfg.SYS.NUM_WORKERS
    train_line = {"train": {"card": card, "model": "SDT-BP", "precision": "bf16", "batch": TB,
                            "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
                            "loop_steps_per_s_with_loader": loop_rates[1],
                            "loop_steps_per_s_first_epoch": loop_rates[0],
                            "loop_epochs": 2, "loop_steps_per_epoch": steps,
                            "loop_clips": len(long_loader.dataset), "loader_workers": workers,
                            "loader_alone_batches_per_s": loader_rate,
                            "reg_loss_bf16_vs_fp32_rel": reg_rel, "grad_cos": grad_cos,
                            "reg_loss_first4": first4, "reg_loss_last4": last4,
                            "mel_train_shape_max_abs_err": train_mel_err}}
    print(f"[train] SDT-BP bf16 B={TB}: mel kernel vs plain at ({TB}, {TL}) max abs err "
          f"{train_mel_err:.3e} (rtol 1e-3, atol 1e-4), quiet half max rel err "
          f"{train_quiet_rel:.3e} (rtol 1e-3); one step launched mel 1, conv1 0, stem 0; stem "
          f"weights got gradients; G_reg_loss {reg16:.6f} vs fp32 all-plain {reg32:.6f} "
          f"(rel {reg_rel:.3e}, <= 0.02), gradient cosine {grad_cos:.6f} (>= 0.99); "
          f"{len(reg)} steps at LR 1e-3: G_reg_loss first-4 mean {first4:.5f} -> last-4 "
          f"{last4:.5f}; step {step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s "
          f"(device-resident batches); trainer loop with loader ({workers} workers, "
          f"{len(long_loader.dataset)} clips, 2 epochs of {steps} steps): "
          f"{loop_rates[0]:.2f} steps/s in the first epoch, {loop_rates[1]:.2f} in the second; "
          f"the loader alone (a third epoch, batches copied to the card) {loader_rate:.2f} "
          f"batches/s",
          flush=True)
    del state, long_loader, loader
    shutil.rmtree(long_root, ignore_errors=True)

    # ---- 11. training command line ---------------------------------------------------
    runs = os.path.join(work, "runs")
    shutil.rmtree(runs, ignore_errors=True)
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.main",
                        "--device", "cuda", "--tag", "chip_smoke", *opts,
                        "SYS.OUTPUT_DIR", runs, "TRAIN.NUM_EPOCHS", "2"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"training CLI rc {r.returncode}:\n{r.stdout}\n{r.stderr}")
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    ckpt = summary.get("checkpoint")
    check(bool(ckpt) and os.path.exists(ckpt) and summary["steps"] == 4,
          f"training CLI line: {summary}")
    served = os.path.join(work, "trained_out.npz")
    r = subprocess.run([sys.executable, "-m", "speechdrivestemplates_tpu_torch.serving",
                        ckpt, wav_path, served, "--device", "cuda"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"serving CLI on the trained checkpoint rc {r.returncode}:\n"
                             f"{r.stdout}\n{r.stderr}")
    with np.load(served) as z:
        got = z["poses"]
    check(got.shape == (64, 2, 121) and bool(np.isfinite(got).all()),
          f"poses served from the trained checkpoint: {got.shape}")
    print(f"[train-cli] 2 epochs, {summary['steps']} steps, last losses "
          f"{summary['losses']}; {os.path.relpath(ckpt, ROOT)} served: {r.stdout.strip()}",
          flush=True)

    # ---- summary -----------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: report[n][k] for k in keys}
                                  for n in ("mel", "conv1", "stem", "shift_probe")]}))
    print(json.dumps(train_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
