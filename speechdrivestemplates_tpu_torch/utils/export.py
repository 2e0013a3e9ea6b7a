"""Export of the wav -> pose serving function with ``torch.export``: the port's
counterpart of the JAX package's ``utils/export.py``.

``export_serving_fn`` loads a reference-layout ``.pth``, traces
``serving.ServingModule`` (mel frontend, generator, the speaker's statistics,
as ``build_serving_fn`` runs them) with ``torch.export.export`` at static
example inputs, drops the host-only checks the trace records beside each
``.to()`` (``drop_metadata_asserts``: on an H100 they added 0.73 ms to a
B = 128 call and 1.90 ms to a B = 1 call), and writes the program with
``torch.export.save``: the generator's weights and the speaker's statistics
are baked in. Shapes are static, as in JAX's: one artifact per (batch, audio
length) serving point. ``<path>.json`` is a sidecar with the calling
convention. The port's spans (``utils/trace.py``) are host code, off outside
a profiler session: the graph holds none of them.

The artifact holds the route of the device it was exported on. Exported on
the card, its graph calls the kernels as ``torch.ops.sdt.*`` (the export
raises unless it calls each kernel of the model's route as often as
``route_ops`` says: once, ``bn_act`` once a BN layer and ``in_act`` once an
IN layer after the stem); exported on
the CPU, it holds the plain route and no kernel op. It loads on that device
only (``load_serving_fn``), in a process that has registered the ``sdt`` ops
by importing ``kernels``, as this module does: ``torch.export.load`` refuses
a graph with an unknown operator. Loading needs nothing else of the port, so
a serving host runs an artifact with ``run_artifact.py`` alone.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Callable, Dict, Optional

import torch

from .. import kernels  # noqa: F401  (registers torch.ops.sdt.*, which artifacts call)
from ..ops.mel import SAMPLE_RATE
from .device import resolve_device


def graph_ops(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """The ``sdt`` ops a program's graph calls, by name ("sdt.mel"), with counts."""
    names = (str(n.target).rsplit(".", 1)[0] for n in program.graph.nodes
             if n.op == "call_function" and str(n.target).startswith("sdt."))
    return dict(sorted(collections.Counter(names).items()))


def drop_metadata_asserts(program: torch.export.ExportedProgram) -> int:
    """Remove the graph's ``aten._assert_tensor_metadata`` nodes, which
    ``torch.export`` records beside each ``.to()``: host-only checks of a dtype
    and device that the static example inputs already fix, run at every call.
    Returns how many went."""
    graph = program.graph
    asserts = [n for n in graph.nodes if n.op == "call_function"
               and n.target is torch.ops.aten._assert_tensor_metadata.default]
    for n in asserts:
        graph.erase_node(n)
    program.graph_module.recompile()
    return len(asserts)


def route_ops(model: torch.nn.Module) -> Dict[str, int]:
    """The kernel ops one call of the card's serving route through the
    generator ``model`` makes: the mel kernel; the conv1 and stem kernels of
    an InstanceNorm audio encoder; bn_act once for each BatchNorm layer (a
    ``ConvNormRelu`` with a norm module: s2g's 24); in_act once for each IN
    layer after the stem (SDT-BP's 21: audio encoder layers 3-7, the UNet's
    12 and the decoder's 4)."""
    from ..models.blocks import ConvNormRelu

    ops = {"sdt.mel": 1}
    layers = [m for m in model.modules() if isinstance(m, ConvNormRelu)]
    bn = sum(m.norm is not None for m in layers)
    in_layers = len(layers) - bn
    if model.audio_encoder.norm == "IN":
        ops.update({"sdt.conv1_in": 1, "sdt.stem": 1})
        in_layers -= 3  # the stem's
    for name, n in (("sdt.bn_act", bn), ("sdt.in_act", in_layers)):
        if n:
            ops[name] = n
    return ops


def export_serving_fn(cfg, checkpoint: str, out_path: str, batch_size: int = 1,
                      audio_length: Optional[int] = None, device="cuda") -> dict:
    """Export ``checkpoint``'s serving function at (batch_size, audio_length)
    on ``device`` to ``out_path``; returns the sidecar, also written to
    ``<out_path>.json``. ``audio_length`` defaults to DATASET.AUDIO_LENGTH."""
    # the model code: an export needs it, a load does not
    from ..models import MODELS
    from ..serving import ServingModule
    from .weights import load_reference_pth

    if cfg.PIPELINE_TYPE != "Voice2Pose":
        raise ValueError("the serving export is the wav -> pose path; "
                         f"{cfg.PIPELINE_TYPE} has no audio input")
    if not MODELS[cfg.VOICE2POSE.GENERATOR.NAME].MEL_INPUT:
        raise ValueError(f"{cfg.VOICE2POSE.GENERATOR.NAME}: the serving export covers "
                         "mel-input generators only")
    device = resolve_device(device)
    module = ServingModule(cfg, load_reference_pth(checkpoint), device)
    audio_length = audio_length or cfg.DATASET.AUDIO_LENGTH
    code_dim = cfg.VOICE2POSE.GENERATOR.CLIP_CODE.DIMENSION if module.has_code else None
    args = (torch.zeros(batch_size, audio_length, device=device),)
    if code_dim is not None:
        args += (torch.zeros(batch_size, code_dim, device=device),)
    with torch.no_grad():
        # an eager call first: the constant tensors it caches on the device go
        # into the graph as constants, not as copies made at every call
        module(*args)
        program = torch.export.export(module, args)
    drop_metadata_asserts(program)
    ops = graph_ops(program)
    want = route_ops(module.model) if device.type == "cuda" else {}
    if ops != want:
        raise RuntimeError(f"the {device.type} export calls the kernel ops {ops}, "
                           f"expected {want}")
    program.example_inputs = None  # else saved too: B x L zeros, 35 MB at B = 128
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    meta = {
        "format": "torch.export ExportedProgram",
        "pipeline": cfg.PIPELINE_TYPE,
        "speaker": cfg.DATASET.SPEAKER,
        "batch_size": batch_size,
        "audio_length": audio_length,
        "sample_rate": SAMPLE_RATE,
        "num_frames": cfg.DATASET.NUM_FRAMES,
        "num_landmarks": cfg.DATASET.NUM_LANDMARKS,
        "code_dim": code_dim,
        "inputs": (["audio f32[B,L]", "code f32[B,D]"] if code_dim is not None
                   else ["audio f32[B,L]"]),
        "output": "poses f32[B,T,2,K] (pixel space)",
        "checkpoint": os.path.abspath(checkpoint),
        "bytes": os.path.getsize(out_path),
        "device": device.type,
        "torch_version": torch.__version__,
        "ops": ops,
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_serving_fn(path: str, device=None) -> Callable:
    """``fn(audio[, code]) -> poses`` over the artifact at ``path``, with
    ``build_serving_fn``'s calling convention at the artifact's shapes (a
    code-less artifact ignores ``code``); ``fn.meta`` is its sidecar.
    ``device`` defaults to the one it was exported for, and must be that one."""
    with open(path + ".json") as f:
        meta = json.load(f)
    device = torch.device(device or meta["device"])
    if device.type != meta["device"]:
        raise ValueError(f"{path} was exported for {meta['device']} and loads there "
                         f"only, not on {device.type}")
    device = resolve_device(device)
    module = torch.export.load(path).module()
    has_code = meta["code_dim"] is not None

    @torch.inference_mode()
    def fn(audio, code=None):
        args = (torch.as_tensor(audio, dtype=torch.float32, device=device),)
        if has_code:
            if code is None:
                raise ValueError("this artifact takes a template code")
            args += (torch.as_tensor(code, dtype=torch.float32, device=device),)
        return module(*args)

    fn.meta = meta
    return fn
