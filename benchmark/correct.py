"""How ``correct`` is decided: the port's outputs against the plain float32
reference (``reference/``, reached through the configuration's model module,
``models/``), each number beside its limit from ``limits/<cell>.json``.

Poses: ``pose_err`` is RMS(program - reference) / RMS(reference - the
speaker's mean pose) over every compared frame, ``worst_clip_pose_err`` the
same ratio of the worst clip (one wrong answer shows there). Training (the
first three steps, followed by the reference from the same weights, bank and
rows): ``loss_gap``, the largest relative gap of a step's ``G_loss``;
``grad_gap``, the worst leaf's gap between the first gradient's norms (the
program's read from Adam's first moment after step 1), over the larger of
that leaf's reference norm and the median leaf's; ``update_gap``, the same of
each leaf's change over the three steps, leaving out leaves whose reference
gradient is under a thousandth of the median leaf's (round-off alone moves
them under Adam); ``grad_diff_median``, the median leaf's norm of the first
gradient's difference over the same denominator. Norms of gradients and of
Adam's changes hardly move under a lower precision (its errors are random and
cancel in a norm), so the last number is the one the control fails. The
control computes the reference with every convolution's operands and output
in fp8 e4m3 and their gradients in e5m2 (one scale a tensor): the precision
below the configuration's bf16.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import pose as ref_pose

BLOCK = 32  # reference rows at a time


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    s = t.abs().amax().clamp_min(1e-30) / top
    return (t / s).to(dtype).to(t.dtype) * s


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 under one scale a tensor. Backward: the incoming
    gradient in e5m2 under one scale, as fp8 training keeps gradients."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """A convolution operand of the control: rounded to float8 e4m3, its
    gradient to e5m2 (the precision below the configurations' bf16)."""
    return _Fp8.apply(t)


def pose_numbers(pairs: List[Tuple[torch.Tensor, torch.Tensor]], m: dict, stat: dict
                 ) -> List[tuple]:
    """``pose_err`` and ``worst_clip_pose_err`` of (program, reference) pairs."""
    k = m["num_landmarks"]
    err2 = ref2 = 0.0
    worst = 0.0
    for prog, ref in pairs:
        base = ref_pose.final_poses(torch.zeros((1, 1, 2, k), device=ref.device), stat,
                                    m["hierarchical_pose"])
        d = (prog.double() - ref.double()).pow(2).flatten(1).sum(1)
        r = (ref.double() - base.double()).pow(2).flatten(1).sum(1)
        err2 += float(d.sum())
        ref2 += float(r.sum())
        worst = max(worst, float((d / r).sqrt().max()))
    return [("pose_err", (err2 / ref2) ** 0.5), ("worst_clip_pose_err", worst)]


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep,
               difference: bool = False) -> List[float]:
    """Each leaf's gap of norms (or, with ``difference``, the norm of the
    difference) over the larger of its reference norm and the median leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))

    def gap(k):
        if difference:
            return float((prog[k].double() - ref[k].double()).norm())
        return abs(float(prog[k].double().norm()) - norms[k])

    return [gap(k) / max(norms[k], med, 1e-30) for k in keep]


def train_numbers(prog: dict, ref: dict) -> List[tuple]:
    loss_gap = max(abs(p["G_loss"] - r["G_loss"]) / abs(r["G_loss"])
                   for p, r in zip(prog["losses"], ref["losses"]))
    leaves = sorted(ref["grad"])
    gnorm = {k: float(ref["grad"][k].double().norm()) for k in leaves}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k in leaves if gnorm[k] >= 1e-3 * med]
    diff = _leaf_gaps(prog["grad"], ref["grad"], leaves, difference=True)
    return [("loss_gap", loss_gap),
            ("grad_gap", max(_leaf_gaps(prog["grad"], ref["grad"], leaves))),
            ("update_gap", max(_leaf_gaps(prog["change"], ref["change"], moving))),
            ("grad_diff_median", float(np.median(diff)))]


def judge(numbers: List[tuple], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """``correct`` and the lines to print: every number with its limit; a
    number without a limit, or a NaN, fails."""
    rows, ok = [], True
    for name, value in numbers:
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok &= good
        rows.append({"name": name, "value": value, "limit": limit})
    missing = set(limits) - {n for n, _ in numbers}
    for name in sorted(missing):
        ok = False
        rows.append({"name": name, "value": None, "limit": limits[name]})
    return ok, rows
