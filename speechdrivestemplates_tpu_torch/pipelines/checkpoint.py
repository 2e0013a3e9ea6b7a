"""Checkpoints of a training run: lookup, the resume file, atomic writes.

A run writes ``<run>/checkpoints/checkpoint_epoch-E_step-S.pth`` in the
reference layout (weights, banks, norm statistics) and beside it
``checkpoint_epoch-E_step-S.train.pt``, the resume file: what the ``.pth``
cannot hold and ``--resume_from`` needs to continue the run exactly (the
optimizers' and schedulers' ``state_dict()``s, the train state's step count
and noise generator, the epoch and global step). The resume file is written
first and the ``.pth`` second, each to a temporary name then ``os.replace``d,
so a ``.pth`` that exists always has a complete resume file beside it, even
under preemption.

``checkpoint_key``, ``resolve_checkpoint`` and ``find_auto_resume_candidates``
are the JAX ``Trainer``'s static methods of those names, over ``.pth`` files
instead of orbax directories.
"""

from __future__ import annotations

import collections
import os
import re
from typing import Dict, List, Tuple

import torch

PTH = ".pth"
RESUME = ".train.pt"
_STAMP = re.compile(r"^\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2}(-\d+)?_")


def checkpoint_name(epoch: int, step: int) -> str:
    return f"checkpoint_epoch-{epoch}_step-{step}{PTH}"


def resume_path(pth: str) -> str:
    """The resume file beside ``pth``."""
    return pth[: -len(PTH)] + RESUME if pth.endswith(PTH) else pth + RESUME


def checkpoint_key(name: str) -> Tuple[int, int]:
    """(epoch, step) parsed from a ``checkpoint_epoch-E_step-S[.pth]`` name;
    (-1, -1) for anything unparseable (sorts last)."""
    name = os.path.basename(name)
    if name.endswith(PTH):
        name = name[: -len(PTH)]
    try:
        return int(name.split("epoch-")[1].split("_")[0]), int(name.split("step-")[1])
    except (IndexError, ValueError):
        return -1, -1


def _checkpoints_in(directory: str) -> List[str]:
    return [e for e in os.listdir(directory) if e.startswith("checkpoint_") and e.endswith(PTH)]


def resolve_checkpoint(path: str) -> str:
    """A checkpoint file, an experiment directory or its ``checkpoints/``
    directory -> the checkpoint, the newest (epoch, step) by number."""
    path = os.path.abspath(path)
    if os.path.basename(path).startswith("checkpoint_") or os.path.isfile(path):
        return path
    cand = path
    if os.path.isdir(os.path.join(path, "checkpoints")):
        cand = os.path.join(path, "checkpoints")
    entries = _checkpoints_in(cand)
    if not entries:
        raise FileNotFoundError(
            f"no checkpoint_*{PTH} under {cand!r} (from {path!r}); pass a checkpoint, "
            "an experiment directory, or a checkpoints/ directory")
    return os.path.join(cand, max(entries, key=checkpoint_key))


def find_auto_resume_candidates(root: str, tag: str) -> List[str]:
    """Every checkpoint of every run directory made for ``tag`` (named
    ``<datetime>_<tag>``, the tag matched exactly after the stamp), newest
    (epoch, step) first; the caller tries them in order."""
    if not os.path.isdir(root):
        return []
    found = []
    for d in sorted(os.listdir(root)):
        m = _STAMP.match(d)
        if not m or d[m.end():] != tag:
            continue
        ckdir = os.path.join(root, d, "checkpoints")
        if not os.path.isdir(ckdir):
            continue
        for e in _checkpoints_in(ckdir):
            if checkpoint_key(e) >= (0, 0):
                found.append((checkpoint_key(e), os.path.join(ckdir, e)))
    return [p for _, p in sorted(found, reverse=True)]


def atomic_save(obj, path: str) -> None:
    """``torch.save`` to a temporary name in the same directory, then rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _plain_schedulers(sds: List[dict]) -> List[dict]:
    """MultiStepLR keeps its milestones in a Counter: stored as a dict, so the
    resume file loads with ``weights_only=True``."""
    return [{k: dict(v) if isinstance(v, collections.Counter) else v for k, v in sd.items()}
            for sd in sds]


def save_checkpoint(state, pth: str, epoch: int, global_step: int) -> None:
    """The resume file, then the reference-layout ``.pth``."""
    train_sd = state.train_state_dict()
    train_sd["schedulers"] = _plain_schedulers(train_sd["schedulers"])
    atomic_save({"epoch": int(epoch), "global_step": int(global_step), **train_sd},
                resume_path(pth))
    state.save_checkpoint(pth, epoch, global_step)


def read_resume(pth: str) -> Dict[str, object]:
    """The resume file beside ``pth``, on the CPU (``load_train_state`` puts
    each optimizer tensor where its parameter lives)."""
    sd = torch.load(resume_path(pth), map_location="cpu", weights_only=True)
    sd["schedulers"] = [{k: collections.Counter(v) if k == "milestones" else v
                         for k, v in s.items()} for s in sd["schedulers"]]
    return sd
