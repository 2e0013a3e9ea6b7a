"""SDT-BP's train step in plain PyTorch: the generator in train mode (an IN
generator computes the same function as in eval), L1 x LAMBDA_REG plus the KL
of the batch's codes to N(0, 1) x LAMBDA_CLIP_KL (skipped while a code
variance is exactly 0), one backward, then torch's Adam (betas 0.9, 0.999,
eps 1e-8; L2 weight decay on the generator) on the generator and on the code
bank, written out."""

from typing import Callable, Dict, Optional

import torch

from . import generator, mel

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def losses(params: Dict[str, torch.Tensor], bank: torch.Tensor, batch: Dict[str, torch.Tensor],
           m: dict, quant: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """``{"G_reg_loss", "G_clipcode_kl_loss", "G_loss"}`` of one batch; ``m`` is
    the configuration's ``model`` entry."""
    spec = mel.mel_spectrogram(batch["audio"])
    code = bank[batch["clip_index"]]
    pred = generator.forward(params, spec, m["num_frames"], code, m["norm"], m["leaky_slope"],
                             m["num_landmarks"], quant)
    reg = (pred - batch["poses"]).abs().mean() * m["lambda_reg"]
    mu, var = code.mean(0), code.var(0, correction=1)
    safe = torch.where(var > 0, var, torch.ones_like(var))
    kl = 0.5 * (-torch.log(safe) + mu ** 2 + var - 1.0).mean() * m["lambda_clip_kl"]
    kl = torch.where((var != 0).all(), kl, torch.zeros_like(kl))
    return {"G_reg_loss": reg, "G_clipcode_kl_loss": kl, "G_loss": reg + kl}


class Adam:
    """torch.optim.Adam's arithmetic on a dict of tensors."""

    def __init__(self, lr: float, weight_decay: float = 0.0):
        self.lr, self.wd, self.t, self.m, self.v = lr, weight_decay, 0, {}, {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = BETAS
        for k, g in grads.items():
            if self.wd:
                g = g + self.wd * params[k]
            m = self.m[k] = b1 * self.m.get(k, torch.zeros_like(g)) + (1 - b1) * g
            v = self.v[k] = b2 * self.v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
            denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5) + ADAM_EPS
            params[k] = params[k] - (self.lr / (1 - b1 ** self.t)) * m / denom


def run_steps(params: Dict[str, torch.Tensor], bank: torch.Tensor, batches, m: dict,
              quant: Optional[Callable] = None) -> dict:
    """The first ``len(batches)`` steps from ``params`` and ``bank`` (float32
    copies are made): each step's losses, the first step's gradient of every
    leaf, and every leaf's change over the steps. The bank is leaf
    ``clips_code``."""
    params = {k: v.detach().float().clone() for k, v in params.items()}
    params["clips_code"] = bank.detach().float().clone()
    start = {k: v.clone() for k, v in params.items()}
    opt_g = Adam(m["lr"], m["weight_decay"])
    opt_c = Adam(m["lr"] * m["code_lr_scaling"])
    out = {"losses": [], "grad": None}
    for batch in batches:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        ls = losses({k: v for k, v in leaves.items() if k != "clips_code"},
                    leaves["clips_code"], batch, m, quant)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(ls["G_loss"], [leaves[k] for k in names])))
        out["losses"].append({k: float(v.detach()) for k, v in ls.items()})
        if out["grad"] is None:
            out["grad"] = {k: g.detach() for k, g in grads.items()}
        params = {k: v.detach() for k, v in leaves.items()}
        with torch.no_grad():
            code = {"clips_code": params.pop("clips_code")}
            opt_g.step(params, {k: grads[k] for k in params})
            opt_c.step(code, {"clips_code": grads["clips_code"]})
            params.update(code)
    out["change"] = {k: (params[k] - start[k]) for k in params}
    return out
