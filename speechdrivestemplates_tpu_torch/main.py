"""Train SDT-BP with the port from a speaker directory:

    python -m speechdrivestemplates_tpu_torch.main [--device cuda|cpu] [--tag T] [KEY VALUE ...]

The ``sdt_bp()`` preset (bf16) with the ``KEY VALUE`` overrides of
``config.apply_overrides``, e.g. ``DATASET.ROOT_DIR datasets/speakers
DATASET.SPEAKER oliver TRAIN.NUM_EPOCHS 100``. Validation and videos are not
ported yet, so ``TRAIN.VALIDATE False TRAIN.SAVE_VIDEO False`` are required.
Runs on the card unless ``--device cpu`` is given, and raises without one.
Prints one JSON line at the end: the steps taken, the last losses and the
last checkpoint, which ``python -m speechdrivestemplates_tpu_torch.serving``
loads.
"""

from __future__ import annotations

import argparse
import json
import logging

from .config import apply_overrides, sdt_bp
from .pipelines.trainer import train
from .utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.main",
                                 description="train SDT-BP (the port, PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tag", default="sdt_bp", help="name of the run's output directory")
    ap.add_argument("opts", nargs="*", metavar="KEY VALUE", help="config overrides")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    try:
        cfg = apply_overrides(sdt_bp(), args.opts)
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)-0.5s] %(message)s")
    summary = train(cfg, args.tag, device)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
