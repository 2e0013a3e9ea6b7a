"""The one general generator of the benchmark's traffic: a traffic file's
``kind`` picks how the port is driven, its other keys are the parameters.
Each kind is ``kinds/<kind>.py`` (``serve``, ``train_cache`` and ``demo``
are there), whose ``Driver`` subclasses ``Driver`` below: ``setup()``,
``window(seconds, win)`` returning its end-to-end values and its work counts,
``free()``, and ``check(control)`` returning the numbers compared with the
reference (``correct.py``). What is particular to a model (its leaves, the
port's state, the reference) comes from the configuration's model module
(``models/``), ``self.mm``.
"""

import importlib
from typing import Dict

import numpy as np
import torch

from . import spec
from .reference import pose as ref_pose


def load_model(conf: dict):
    """The configuration's model module, ``models/<name>.py``."""
    return importlib.import_module(f"{__package__}.models.{spec.model_name(conf)}")


def port_config(conf: dict, mm):
    """The port's configuration tree as ``main.py`` reads the configuration's
    file (its tree and overrides are in the benchmark's configuration file),
    held to the plain numbers the reference reads (``mm.port_keys``)."""
    from speechdrivestemplates_tpu_torch import config as C

    pc = conf["port_config"]
    cfg = C.Config()
    cfg.DATASET.SPEAKER = C.DEFAULT_SPEAKER
    C.merge_tree(cfg, pc["tree"])
    C.apply_overrides(cfg, list(pc["opts"]))
    C.check_config(cfg)
    m = conf["model"]
    bad = {k: (m[k], v) for k, v in mm.port_keys(cfg).items() if m[k] != v}
    if bad:
        raise ValueError(f"the port's configuration departs from the benchmark's: {bad}")
    return cfg


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream, drawn from
    ``rng`` (Algorithm R): every call of a window is as likely to be checked."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = item


class Driver:
    def __init__(self, cell: dict, seed: int, device, spans):
        self.conf, self.traffic = cell["config_file"], cell["traffic_file"]
        self.model, self.mm = self.conf["model"], load_model(self.conf)
        self.seed, self.device, self.spans = seed, torch.device(device), spans
        self.work: Dict[str, float] = {}

    def build_kernels(self) -> None:
        if self.device.type == "cuda" and self.mm.KERNELS:
            from speechdrivestemplates_tpu_torch import kernels

            kernels.build_all(self.mm.KERNELS)

    def stat(self) -> dict:
        return ref_pose.speaker_stat(self.model["speaker"], self.model["hierarchical_pose"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make(cell: dict, seed: int, device, spans) -> Driver:
    """The driver of the cell's traffic kind, ``kinds/<kind>.py``'s ``Driver``."""
    kind = cell["traffic_file"]["kind"]
    return importlib.import_module(f"{__package__}.kinds.{kind}").Driver(cell, seed, device, spans)
