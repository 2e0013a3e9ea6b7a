"""Train, test, run the demo or export the serving function with the port:

    python -m speechdrivestemplates_tpu_torch.main [--config_file configs/NAME.yaml]
        [--export PATH [--export_batch N] --checkpoint CKPT.pth]
        [--demo_input WAV|"WAV WAV ..."|DIR --checkpoint CKPT.pth]
        [--test_only --checkpoint CKPT.pth] [--resume_from CKPT|RUN_DIR]
        [--pretrain_from CKPT.pth] [--device cuda|cpu] [--tag T] [KEY VALUE ...]

The configuration is the JAX ``main.py``'s (``config.load_config``): the
defaults, then ``--config_file`` (any YAML file in the subset that
``configs/*.yaml`` use; without one, ``configs/voice2pose_sdt_bp.yaml``'s
tree), then the ``KEY VALUE`` overrides, e.g. ``DATASET.ROOT_DIR
datasets/speakers TRAIN.NUM_EPOCHS 100``. A run writes into
``<SYS.OUTPUT_DIR>/<datetime>_<cfg_name>-{TRAIN,TEST,DEMO}-<tag>/``, JAX's
name: ``cfg_name`` is the config file's basename (``voice2pose_sdt_bp``
without one) and ``--tag`` defaults to ''; TRAIN.AUTO_RESUME continues the
newest checkpoint of that exact name. Pose videos and TensorBoard images
follow TRAIN.SAVE_VIDEO, TEST.SAVE_VIDEO and SYS.VIDEO_FORMAT
(``utils/video.py``).
``--demo_input`` runs the demo of ``--checkpoint`` on a wav, a space-separated
list of wavs or a directory of them (DEMO.NUM_SAMPLES of it), at any length up
to DATASET.MAX_DEMO_LENGTH seconds (``pipelines/trainer.py::demo``; for
Pose2Pose it needs DEMO.CODE_PATH);
``--test_only`` evaluates ``--checkpoint`` on the val split instead of training.
``--export PATH`` writes ``--checkpoint``'s wav -> pose serving function at
(``--export_batch``, DATASET.AUDIO_LENGTH) to a ``torch.export`` artifact and
its ``PATH.json`` sidecar (``utils/export.py``; Voice2Pose only), for
the device that ``--device`` names: on the card its graph calls the kernels,
on the CPU the plain route; ``run_artifact.py`` serves it. The export takes
precedence over the demo, the demo over the test, the test over training, as
in the JAX ``main.py``. ``--resume_from`` continues
a run from a checkpoint the port wrote (a ``.pth`` with its resume file, its
run directory or ``checkpoints/``), in that run's directory; ``--pretrain_from``
(TRAIN.PRETRAIN_FROM) starts a new run from a ``.pth``'s weights with fresh
optimizers.
Ranks: with SYS.WORLD_SIZE N > 1 the run (train, test or demo) spawns N
ranks on this host (``parallel.dist.spawn``), each on ``cuda:<rank>`` (or the
CPU with ``--device cpu``), in a process group at SYS.MASTER_ADDR:
SYS.MASTER_PORT over NCCL on the card and gloo on the CPU (``main(...,
backend='gloo')`` asks for gloo on the card); the kernels are built once
before. Under ``torchrun`` (its RANK / WORLD_SIZE / LOCAL_RANK environment)
this process is one rank, on ``cuda:<LOCAL_RANK>``, and the ranks may span
hosts. SYS.DISTRIBUTED True runs a process group at one rank too. Rank 0
writes the run's files and prints the line below; every rank computes the
global batch's losses and metrics (``pipelines/trainer.py``). The defaults
run one process without a group. The export runs in one process.
Runs on the card unless ``--device cpu`` is given, and raises without one.
Prints one JSON line at the end: a training run's steps, last losses, last
checkpoint (which the serving command line loads, given the same
``--config_file``; a code-less s2g checkpoint draws no code there) and the
checkpoint it resumed from, a test run's metrics, the demo's frame counts
and result archives, or the export's sidecar. A training run ended by SIGTERM
(TRAIN.CHECKPOINT_ON_PREEMPT) exits 143 after its checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from . import kernels
from .config import check_config, ignored_keys, load_config
from .parallel import dist as pdist
from .pipelines.trainer import demo, test, train
from .utils.device import resolve_device
from .utils.export import export_serving_fn

def run(cfg, args, cfg_name: str, device) -> dict:
    """The demo, the test or the training run that ``args`` asks for, in
    this process (one rank of several, or the only process)."""
    if args.demo_input:
        return demo(cfg, args.checkpoint, args.demo_input, f"{cfg_name}-DEMO-{args.tag}", device)
    if args.test_only:
        return test(cfg, args.checkpoint, f"{cfg_name}-TEST-{args.tag}", device)
    return train(cfg, f"{cfg_name}-TRAIN-{args.tag}", device, args.resume_from)


def _rank(rank: int, device, cfg, args, cfg_name: str) -> dict:
    """One spawned rank's run (``parallel.dist.spawn`` calls it)."""
    logging.basicConfig(level=logging.INFO, format=f"%(asctime)s [rank {rank}] "
                                                   "[%(levelname)-0.5s] %(message)s")
    return run(cfg, args, cfg_name, device)


def run_ranks(cfg, args, cfg_name: str, device, backend=None) -> dict:
    """``run`` on the ranks the configuration asks for (``main``'s docstring);
    rank 0's summary."""
    env = pdist.torchrun_env()
    if env is not None:
        rank, world, local = env
        if cfg.SYS.WORLD_SIZE not in (1, world):
            raise ValueError(f"SYS.WORLD_SIZE {cfg.SYS.WORLD_SIZE}, but torchrun started "
                             f"{world} ranks")
        cfg.SYS.WORLD_SIZE = world
        check_config(cfg)
        pdist.init_process_group(rank, world, pdist.rank_device(device, local), "env://",
                                 backend)
        try:
            return run(cfg, args, cfg_name, pdist.rank_device(device, local))
        finally:
            pdist.destroy_process_group()
    world = cfg.SYS.WORLD_SIZE
    if world == 1 and not cfg.SYS.DISTRIBUTED:
        return run(cfg, args, cfg_name, device)
    init = f"tcp://{cfg.SYS.MASTER_ADDR}:{cfg.SYS.MASTER_PORT}"
    if world == 1:  # SYS.DISTRIBUTED: a group of one, in this process
        pdist.init_process_group(0, 1, device, init, backend)
        try:
            return run(cfg, args, cfg_name, device)
        finally:
            pdist.destroy_process_group()
    if device.type == "cuda":
        kernels.build_all()  # once here, not by every rank
    return pdist.spawn(_rank, world, (cfg, args, cfg_name), device=device, backend=backend,
                       addr=cfg.SYS.MASTER_ADDR, port=cfg.SYS.MASTER_PORT)[0]


def main(argv=None, backend=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m speechdrivestemplates_tpu_torch.main",
                                 description="train, test, demo or export (the port, PyTorch/CUDA)")
    ap.add_argument("--config_file", default="", metavar="FILE",
                    help="a YAML config file, e.g. configs/voice2pose_sdt_bp.yaml (the "
                         "default's tree)")
    ap.add_argument("--test_only", action="store_true",
                    help="evaluate --checkpoint on the val split instead of training")
    ap.add_argument("--demo_input", default=None, metavar="WAV|DIR",
                    help="run the demo of --checkpoint on this wav, list or directory")
    ap.add_argument("--checkpoint", default=None,
                    help="the .pth that --test_only evaluates, --demo_input runs or "
                         "--export exports")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="export --checkpoint's serving function (weights and speaker "
                         "statistics baked in) to a torch.export artifact at PATH")
    ap.add_argument("--export_batch", type=int, default=1,
                    help="batch size of the --export artifact (shapes are static: one "
                         "artifact per serving batch, e.g. 1 for latency, 128 for "
                         "throughput)")
    ap.add_argument("--resume_from", default=None,
                    help="continue training from this checkpoint (or run directory)")
    ap.add_argument("--pretrain_from", default=None,
                    help="start training from this .pth's weights (TRAIN.PRETRAIN_FROM)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tag", default="",
                    help="tag for the experiment: the run is <cfg_name>-<MODE>-<tag>")
    ap.add_argument("opts", nargs="*", metavar="KEY VALUE", help="config overrides")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if (args.export or args.test_only or args.demo_input) and not args.checkpoint:
        ap.error("--export, --test_only and --demo_input need --checkpoint")
    if args.checkpoint and not (args.export or args.test_only or args.demo_input):
        ap.error("--checkpoint is read by --export, --test_only and --demo_input only")
    try:
        cfg = load_config(args.config_file, args.opts)
    except (KeyError, ValueError, OSError) as e:
        ap.error(str(e))
    if args.pretrain_from is not None:
        cfg.TRAIN.PRETRAIN_FROM = args.pretrain_from
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)-0.5s] %(message)s")
    ignored = ignored_keys(cfg)
    if ignored:
        logging.getLogger(__name__).info("read and ignored (nothing in the port depends on "
                                         "them): %s", ", ".join(ignored))
    # JAX's exp_tag (its main.py): the config file's basename, the mode, the tag
    cfg_name = (os.path.basename(args.config_file).split(".")[0] if args.config_file
                else "voice2pose_sdt_bp")
    if args.export:
        if cfg.PIPELINE_TYPE != "Voice2Pose":
            ap.error(f"--export: {cfg.PIPELINE_TYPE} has no audio input to serve")
        summary = export_serving_fn(cfg, args.checkpoint, args.export,
                                    batch_size=args.export_batch, device=device)
    else:
        summary = run_ranks(cfg, args, cfg_name, device, backend)
        env = pdist.torchrun_env()
        if env is not None and env[0] != 0:  # under torchrun: rank 0 prints
            return summary
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
