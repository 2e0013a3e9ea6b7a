"""The wav -> pose serving function and its command line.

``build_serving_fn(cfg, state_dict, device)`` returns ``(fn, has_code)``:
``fn(audio[, code])`` maps a (B, L) float32 16 kHz waveform batch (and a
(B, code_dim) template code for code models) to (B, num_frames, 2, K) float32
poses in pixel space: the generator's ``features`` of the waveform (the mel
for ``SequenceGeneratorCNN``), generator, the speaker's statistics (the
parted or the global table, as DATASET.HIERARCHICAL_POSE says), and re-rooting
to global coordinates when DATASET.HIERARCHICAL_POSE. B and L come from the
input. ``ServingModule`` is that function as an ``nn.Module``, which
``utils/export.py`` exports at one (B, L) to a file that runs without this
package's model code (``main --export``, ``run_artifact.py``).

On a CUDA device ``fn`` replays a CUDA graph of the module's forward for
each input signature (the audio's (B, L) and the code's shape, or no code)
that repeats, through the capture protocol the train loop shares
(``pipelines/graphed.py``); a call then costs the host one input copy, one
graph launch and one output copy instead of ~330 launches. A signature's
first call is the protocol's eager warm-up, its second captures the forward
and replays it, and every later call replays. The graphs of the
``KEEP_GRAPHS`` most recently used signatures are kept; an evicted signature
starts eagerly again. On the CPU every call is eager. ``fn.routes`` counts
the calls by route (``eager``, ``captured``, ``replayed``). A replayed call
records the spans ``serve.forward`` and, inside it, ``serve.replay``
(``utils/trace.py``); the forward's sections record at a signature's eager
call, and, flagged ``captured``, at its capture. A replay reads the weights
its capture read: ``SequenceGeneratorCNN``'s parameters, and
``SequenceGeneratorHuBERT``'s cache of folded, cast weights, which
``load_state_dict`` refreshes in place. A parameter of the latter changed in
place otherwise reaches a replay only after an eager forward: reload the
state dict after such a change.

Command line (one wav request; a reference-layout ``.pth`` checkpoint):

    python -m speechdrivestemplates_tpu_torch.serving ckpt.pth in.wav out.npz \
        [--config_file configs/NAME.yaml] [--code-seed N] [--device cuda|cpu]
        [--speaker oliver]

``--config_file`` is the Voice2Pose config file the checkpoint was trained
with, read as ``main.py`` reads it (``configs/voice2pose_sdt_bp.yaml``'s tree
by default; ``configs/voice2pose_sdt_vae.yaml``, ``configs/voice2pose_s2g.yaml``
or an edited copy).
The wav is read as the demo reads it (``utils.audio.load_wav``: scipy's
reader, mono, ``resample_poly`` to 16 kHz); audio longer than
DATASET.AUDIO_LENGTH is cropped, shorter audio zero-padded (the demo,
``main --demo_input``, takes any length).
A code model's code is N(0, 1) from ``numpy.random.RandomState(code_seed)``;
a code-less checkpoint (s2g) draws no code.
"""

from __future__ import annotations

import argparse
import collections
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import load_config
from .datasets.speakers_stat import get_speaker_stat
from .models import build_model
from .ops.pose import get_final_results
from .pipelines.graphed import Graph, warm_up
from .utils import trace
from .utils.audio import load_wav
from .utils.device import resolve_device
from .utils.weights import load_reference_pth


class ServingModule(nn.Module):
    """``forward(audio[, code])``: the serving graph over one generator's
    weights and one speaker's statistics, in eval mode with no parameter
    requiring grad; what ``build_serving_fn`` calls and ``utils/export.py``
    exports. The kernels' route is the inputs' device's."""

    def __init__(self, cfg, state_dict: Dict[str, torch.Tensor], device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.model = build_model(cfg.VOICE2POSE.GENERATOR.NAME, cfg, device=device)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.requires_grad_(False)
        self.has_code = cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION is not None
        self.num_frames = cfg.DATASET.NUM_FRAMES
        self.hierarchical = cfg.DATASET.HIERARCHICAL_POSE
        self.num_kp = cfg.DATASET.NUM_LANDMARKS
        stat = get_speaker_stat(cfg.DATASET.SPEAKER, self.num_kp, self.hierarchical)
        self.register_buffer("mean", torch.from_numpy(stat["mean"]).to(device)[None])
        self.register_buffer("std", torch.from_numpy(stat["std"]).to(device)[None])
        self.register_buffer("scale", torch.tensor([float(stat["scale_factor"])],
                                                   device=device))

    def forward(self, audio: torch.Tensor,
                code: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.has_code and code is None:
            raise ValueError("this model takes a template code")
        B = audio.shape[0]
        with trace.span("serve.forward"):
            feats = self.model.features(audio)
            pred = self.model(feats, self.num_frames, code if self.has_code else None)
            with trace.span("final"):
                return get_final_results(pred, self.mean.expand(B, -1), self.std.expand(B, -1),
                                         self.scale.expand(B), self.hierarchical, self.num_kp)


KEEP_GRAPHS = 4  # signatures whose graphs are kept, least recently used evicted


class ServingFn:
    """``build_serving_fn``'s ``fn``: ``fn(audio[, code])`` through ``module``
    on ``device``, eagerly or as a CUDA-graph replay (the module's docstring)."""

    def __init__(self, module: ServingModule, device: torch.device):
        self.module, self.device = module, device
        self.routes: collections.Counter = collections.Counter()
        self.graphs: "collections.OrderedDict[tuple, Graph]" = collections.OrderedDict()
        self.warm: set = set()  # signatures whose eager call has run
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    @torch.inference_mode()
    def __call__(self, audio, code=None) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if code is not None:
            code = torch.as_tensor(code, dtype=torch.float32, device=self.device)
        if self.stream is None:
            out = self.module(audio, code)
            self.routes["eager"] += 1
            return out
        key = (tuple(audio.shape), None if code is None else tuple(code.shape))
        g = self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
            route = "replayed"
        elif key in self.warm:
            while len(self.graphs) >= KEEP_GRAPHS:
                evicted, _ = self.graphs.popitem(last=False)
                self.warm.discard(evicted)
            g = self.graphs[key] = Graph(self.module, (audio, code), self.stream)
            route = "captured"
        else:
            out = warm_up(self.module, (audio, code), self.stream)
            self.warm.add(key)
            self.routes["eager"] += 1
            return out
        with trace.span("serve.forward"), trace.span("serve.replay"):
            out = g(audio, code)
        self.routes[route] += 1
        return out


def build_serving_fn(cfg, state_dict: Dict[str, torch.Tensor],
                     device="cuda") -> Tuple[Callable, bool]:
    """``(fn, has_code)`` over the given generator weights on ``device``;
    ``fn`` is a ``ServingFn``."""
    device = resolve_device(device)
    module = ServingModule(cfg, state_dict, device)
    return ServingFn(module, device), module.has_code


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m speechdrivestemplates_tpu_torch.serving",
        description="wav -> poses with a Voice2Pose generator checkpoint")
    ap.add_argument("checkpoint", help="reference-layout .pth (module.netG.* keys)")
    ap.add_argument("--config_file", default="", metavar="FILE",
                    help="the checkpoint's config file (default: SDT-BP's tree)")
    ap.add_argument("wav")
    ap.add_argument("out", help="output npz (poses in pixel space)")
    ap.add_argument("--code-seed", type=int, default=0,
                    help="seed of the N(0,1) template code")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--speaker", default="oliver")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    try:
        cfg = load_config(args.config_file)
    except (KeyError, ValueError) as e:
        ap.error(str(e))
    if cfg.PIPELINE_TYPE != "Voice2Pose":
        ap.error(f"--config_file {args.config_file}: not a Voice2Pose configuration")
    cfg.DATASET.SPEAKER = args.speaker
    fn, has_code = build_serving_fn(cfg, load_reference_pth(args.checkpoint), device)

    L = cfg.DATASET.AUDIO_LENGTH
    audio = load_wav(args.wav)
    clipped = len(audio) > L
    buf = np.zeros((1, L), np.float32)
    buf[0, : min(len(audio), L)] = audio[:L]
    code = None
    if has_code:
        dim = cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION
        code = np.random.RandomState(args.code_seed).randn(1, dim).astype(np.float32)
    poses = fn(buf, code)[0].float().cpu().numpy()  # (T, 2, K)

    np.savez(args.out, poses=poses, fps=15, num_frames=cfg.DATASET.NUM_FRAMES,
             speaker=args.speaker)
    note = " (input clipped to the serving length)" if clipped else ""
    print(f"{poses.shape[0]} pose frames ({poses.shape[-1]} keypoints) "
          f"-> {args.out}{note}")


if __name__ == "__main__":
    main()
