#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. device   a CUDA device is present; its name and power limit are printed
  2. build    the CUDA kernels compile from speechdrivestemplates_tpu_torch/csrc
  3. mel      the fused STFT+mel kernel vs its plain PyTorch version at (128, 68267)
  4. stem     the fused audio-encoder stem kernel vs its plain version at (128, 80, 427),
              in fp32 (tight tolerance) and in bf16 (the serving dtype)
  5. serve    SDT-BP, bf16, full width, seeded weights: three requests (B = 1, 16, 128)
              through build_serving_fn; the kernels' launch counters must grow on every
              request; the B=128 result is held to an fp32 all-plain forward
  6. cli      the serving command line on a seeded wav and a reference-layout .pth
Then one JSON line with every kernel's error, times, bound and launches, the card's
name and power limit, and last {"ok": true, "device": {...}}.

Times are CUDA-event means over repeated calls after a warm-up; inputs rotate over
three copies so that each call reads from device memory rather than the 50 MB L2.
"""

from __future__ import annotations

import json
import os
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
    from speechdrivestemplates_tpu_torch.ops import mel as M
    from speechdrivestemplates_tpu_torch.ops import stem as S
    from speechdrivestemplates_tpu_torch.serving import build_serving_fn

    dev = torch.device("cuda")
    # reference arithmetic in full fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)

    # ---- 1. device ---------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi unavailable"
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}", flush=True)

    # ---- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build_all()
    for name in kernels.SIGNATURES:
        kernels.library(name)
    print(f"[build] {sorted(kernels.SIGNATURES)} in {time.perf_counter() - t0:.2f} s "
          f"(compiled now: {built})", flush=True)

    def cuda_ms(fn, arg_sets, iters=20):
        for args in arg_sets:
            fn(*args)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def dev_randn(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    report = {}

    # ---- 3. mel kernel -----------------------------------------------------------
    B, L = 128, 68267
    T = L // 160 + 1
    audios = [dev_randn(B, L, scale=0.1) for _ in range(3)]
    k = M.mel_spectrogram_kernel(audios[0])
    p = M.mel_spectrogram_plain(audios[0])
    torch.cuda.synchronize()
    check(k.shape == p.shape == (B, 80, T), f"mel shape {tuple(k.shape)}")
    mel_err = (k - p).abs().max().item()
    check(torch.allclose(k, p, rtol=1e-3, atol=1e-4),
          f"mel kernel vs plain: max abs err {mel_err}")
    fb = torch.from_numpy(M._mel_filterbank_np(16000, 512, 80, 55.0, 7500.0)).to(dev)
    hann = torch.hann_window(400, periodic=True, device=dev)

    def mel_library(a):
        spec = torch.stft(a, 512, 160, 400, hann, center=True, pad_mode="reflect",
                          return_complex=True)
        return fb.T @ (spec.real ** 2 + spec.imag ** 2)

    check(torch.allclose(mel_library(audios[0]), p, rtol=1e-3, atol=1e-4),
          "torch.stft yardstick disagrees with the plain mel")
    n_frames = B * T
    mel_b, mel_by = bound_ms(4.0 * (B * L + B * 80 * T),
                             2.0 * n_frames * (400 * 512 + 256 * 80), "fp32")
    report["mel"] = dict(
        name="mel_stft_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/mel.cu",
        replaces="speechdrivestemplates_tpu/ops/mel_pallas.py:123",
        max_abs_err=mel_err,
        ms=cuda_ms(M.mel_spectrogram_kernel, [(a,) for a in audios]),
        plain_ms=cuda_ms(M.mel_spectrogram_plain, [(a,) for a in audios]),
        bound_ms=mel_b, bound_by=mel_by,
        library_ms=cuda_ms(mel_library, [(a,) for a in audios]))
    print(f"[mel] (128, 68267) max abs err {mel_err:.3e} (rtol 1e-3, atol 1e-4); "
          f"kernel {report['mel']['ms']:.4f} ms, plain {report['mel']['plain_ms']:.4f} ms, "
          f"torch.stft {report['mel']['library_ms']:.4f} ms, bound {mel_b:.4f} ms "
          f"({mel_by})", flush=True)

    # ---- 4. stem kernel ----------------------------------------------------------
    W1 = T
    H2, W2 = S.stem_dims(W1)
    mels = [dev_randn(B, 80, W1) for _ in range(3)]
    w1, w2, w3 = dev_randn(64, 1, 3, 3, scale=0.2), dev_randn(64, 64, 4, 4, scale=0.05), \
        dev_randn(128, 64, 3, 3, scale=0.05)
    ref32 = S.stem_plain(mels[0], w1, w2, w3, 0.2, torch.float32)
    k32 = S.stem_kernel(mels[0], w1, w2, w3, 0.2, torch.float32)
    torch.cuda.synchronize()
    check(k32.shape == ref32.shape == (B, H2, W2, 128), f"stem shape {tuple(k32.shape)}")
    stem_err = (k32 - ref32).abs().max().item()
    # both sides accumulate fp32 products of the same operands (no TF32): they differ
    # by summation order only, ~1e-6 relative on O(1) post-norm values
    check(torch.allclose(k32, ref32, rtol=2e-4, atol=2e-5),
          f"stem fp32 kernel vs plain: max abs err {stem_err}")
    k16 = S.stem_kernel(mels[0], w1, w2, w3, 0.2, torch.bfloat16).float()
    err16 = (k16 - ref32).abs().flatten()
    q99 = torch.quantile(err16[:: max(1, err16.numel() // 4_000_000)], 0.99).item()
    check(q99 < 0.05 and err16.mean().item() < 0.02,
          f"stem bf16 kernel vs fp32 plain: p99 {q99}, mean {err16.mean().item()}")
    del ref32, k32, k16, err16

    def stem_library(mel):
        x = F.conv2d(mel[:, None].to(torch.bfloat16), w1.to(torch.bfloat16), padding=1)
        for w, s in ((w2, 2), (w3, 1)):
            x = F.leaky_relu(F.instance_norm(x), 0.2)
            x = F.conv2d(x, w.to(torch.bfloat16), stride=s, padding=1)
        return F.leaky_relu(F.instance_norm(x), 0.2)

    bf = torch.bfloat16
    stem_flops = 2.0 * B * 80 * W1 * 64 * 9 + 2.0 * B * H2 * W2 * (
        64 * 64 * 16 + 128 * 64 * 9)
    stem_bytes = 4.0 * B * 80 * W1 + 4.0 * (w1.numel() + w2.numel() + w3.numel()) \
        + 2.0 * B * H2 * W2 * 128
    stem_b, stem_by = bound_ms(stem_bytes, stem_flops, "bf16")
    stem_args = [(m, w1, w2, w3, 0.2, bf) for m in mels]
    report["stem"] = dict(
        name="audio_encoder_stem_fused", route="cuda",
        source="speechdrivestemplates_tpu_torch/csrc/stem.cu",
        replaces="probes/stem_pallas.py:192",
        max_abs_err=stem_err,
        ms=cuda_ms(S.stem_kernel, stem_args, 10),
        plain_ms=cuda_ms(S.stem_plain, stem_args, 10),
        bound_ms=stem_b, bound_by=stem_by,
        library_ms=cuda_ms(stem_library, [(m,) for m in mels], 10))
    print(f"[stem] (128, 80, {W1}) fp32 max abs err {stem_err:.3e} (rtol 2e-4, atol 2e-5); "
          f"bf16 vs fp32 p99 {q99:.4f} (< 0.05); bf16 kernel {report['stem']['ms']:.4f} ms, "
          f"plain {report['stem']['plain_ms']:.4f} ms, cuDNN {report['stem']['library_ms']:.4f} ms, "
          f"bound {stem_b:.4f} ms ({stem_by})", flush=True)
    del mels, audios

    # ---- 5. serving --------------------------------------------------------------
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
    growth = {name: [s.get(name, 0) for s in seen] for name in ("mel", "stem")}
    for name, counts in growth.items():
        check(counts == [1, 2, 3], f"{name} kernel launches per request: {counts}")
    report["mel"]["launches"] = launches["mel"]
    report["stem"]["launches"] = launches["stem"]

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

    # ---- 6. command line ---------------------------------------------------------
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

    # ---- summary -----------------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: report[n][k] for k in keys}
                                  for n in ("mel", "stem")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
