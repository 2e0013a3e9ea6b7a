"""One stage of the paper's chain through the port's command line, at the
budget of the JAX package's ``bench_e2e.py`` (stages 1, 2, 3 and 5):

    python -m speechdrivestemplates_tpu_torch.chain_e2e STAGE [--out DIR] [--keep DIR]
        [--ae CKPT] [--bp CKPT] [--train 1024] [--dev 131] [--epochs 100] [--batch 32]
        [--device cuda|cpu]

STAGE is ``pose2pose`` (the VAE), ``sdt_bp`` (with ``--ae`` as the frozen FGD
encoder, VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT), ``sdt_vae`` (on ``--ae``'s
bank) or ``test`` (``--test_only --checkpoint`` of ``--bp``, ``--ae`` as
AE_CHECKPOINT). The synthetic speaker (``datasets/synthetic.py``, seed 0, the
fixture ``bench_e2e.py`` writes) is made under ``DIR/data`` once. Every stage
takes ``bench_e2e.py``'s overrides: TRAIN.NUM_EPOCHS, TRAIN.BATCH_SIZE and
TEST.BATCH_SIZE, CHECKPOINT_INTERVAL 10, validation on, no videos, a log line
every 200 steps. Each stage is one ``python -m speechdrivestemplates_tpu_torch.
main`` process, timed by the host clock. ``--keep`` receives the stage's last
checkpoint and its log.

Prints one JSON line: the stage, its wall seconds, its steps and steps/s over
the training epochs (each epoch's own time, validation and checkpoints
included), the last losses and validation metrics or the test metrics, and,
for the test stage at the reference budget, each metric against
``bench_e2e.py``'s ACCEPTANCE_BANDS (exit code 1 when one falls outside).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

from .utils.device import resolve_device

# bench_e2e.py's bands for the converged metrics on this fixture (1,024 + 131
# clips, 100 epochs, batch 32, seed 0)
ACCEPTANCE_BANDS = {"L2_dist": (100.0, 185.0), "lip_sync_error_n": (0.45, 1.10),
                    "FGD_mu": (2.0, 45.0), "FGD_mu_logvar": (2.0, 45.0)}
CONFIGS = {"pose2pose": "configs/pose2pose.yaml", "sdt_bp": "configs/voice2pose_sdt_bp.yaml",
           "sdt_vae": "configs/voice2pose_sdt_vae.yaml", "test": "configs/voice2pose_sdt_bp.yaml"}
_EPOCH = re.compile(r"\[TRAIN\] epoch \d+/\d+: (\d+) steps in ([0-9.]+) s")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.chain_e2e")
    ap.add_argument("stage", choices=sorted(CONFIGS))
    ap.add_argument("--out", default="build/chain", help="data and run directories")
    ap.add_argument("--keep", default=None, help="copy the last checkpoint and log here")
    ap.add_argument("--ae", default=None, help="the Pose2Pose checkpoint")
    ap.add_argument("--bp", default=None, help="the SDT-BP checkpoint that `test` evaluates")
    ap.add_argument("--train", type=int, default=1024)
    ap.add_argument("--dev", type=int, default=131)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.stage != "pose2pose" and not args.ae:
        ap.error(f"stage {args.stage} needs --ae")
    if args.stage == "test" and not args.bp:
        ap.error("stage test needs --bp")

    data = os.path.join(args.out, "data")
    marker = os.path.join(data, f".made_{args.train}_{args.dev}")
    if not os.path.exists(marker):
        from .datasets.synthetic import make_synthetic_speaker

        shutil.rmtree(data, ignore_errors=True)
        tic = time.perf_counter()
        make_synthetic_speaker(data, "oliver", num_train=args.train, num_dev=args.dev)
        open(marker, "w").close()
        print(f"{args.train} + {args.dev} clips written in {time.perf_counter() - tic:.1f} s",
              flush=True)

    runs = os.path.join(args.out, args.stage)
    cmd = [sys.executable, "-m", "speechdrivestemplates_tpu_torch.main", "--device",
           args.device, "--config_file", CONFIGS[args.stage], "--tag", args.stage]
    if args.stage == "test":
        cmd += ["--test_only", "--checkpoint", args.bp]
    cmd += ["DATASET.ROOT_DIR", data, "DATASET.SPEAKER", "oliver", "SYS.OUTPUT_DIR", runs,
            "TRAIN.NUM_EPOCHS", str(args.epochs), "TRAIN.BATCH_SIZE", str(args.batch),
            "TEST.BATCH_SIZE", str(args.batch),
            "TRAIN.CHECKPOINT_INTERVAL", str(min(10, args.epochs)),
            "TRAIN.SAVE_VIDEO", "False", "TEST.SAVE_VIDEO", "False", "SYS.LOG_INTERVAL", "200"]
    if args.ae and args.stage != "pose2pose":
        cmd += ["VOICE2POSE.POSE_ENCODER.AE_CHECKPOINT", args.ae]
    tic = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - tic
    if r.returncode:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
        raise SystemExit(f"stage {args.stage}: main exited {r.returncode}")
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    log = glob.glob(os.path.join(summary["output_dir"], "*.log"))[0]  # <cfg_name>-<MODE>-<tag>
    with open(log) as f:
        epochs = [(int(n), float(s)) for n, s in _EPOCH.findall(f.read())]
    line = {"stage": args.stage, "wall_s": wall, "summary": summary}
    if epochs:
        steps, seconds = sum(n for n, _ in epochs), sum(s for _, s in epochs)
        line.update(steps=steps, train_s=seconds, steps_per_s=steps / seconds)
    if args.keep:
        os.makedirs(args.keep, exist_ok=True)
        shutil.copy(log, os.path.join(args.keep, f"{args.stage}.log"))
        if summary.get("checkpoint") and args.stage != "test":
            shutil.copy(summary["checkpoint"], os.path.join(args.keep, f"{args.stage}.pth"))
    ok = True
    if args.stage == "test" and (args.train, args.epochs, args.batch) == (1024, 100, 32):
        metrics = summary["metrics"]
        line["acceptance"] = {k: {"value": metrics.get(k), "band": list(band),
                                  "ok": k in metrics and band[0] <= metrics[k] <= band[1]}
                              for k, band in ACCEPTANCE_BANDS.items()}
        ok = all(v["ok"] for v in line["acceptance"].values())
    print(json.dumps(line))
    if not ok:
        raise SystemExit(1)
    return line


if __name__ == "__main__":
    main()
