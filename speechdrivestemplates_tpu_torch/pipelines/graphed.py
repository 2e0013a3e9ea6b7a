"""The port's CUDA graphs: one capture protocol, and K train steps a graph.

``warm_up`` and ``Graph`` are the capture protocol that the serving function
(``serving.py::ServingFn``) and the train loop (``ChunkRunner``) share.
Capture records and runs nothing, so a function's first run is eager
(``warm_up``), on the stream that captures next: it builds every lazily made
constant (the mel kernel's tables, the resize matrices, the pose index
tables, the optimizers' state, the handles' workspaces) before a capture
could try to copy one from host memory, and makes cuDNN's plans and the
kernels' one-time ``cudaFuncSetAttribute`` calls (``csrc/mel.cu``,
``conv1.cu`` and ``stem.cu`` make it at their first launch in a process), so
none happens under capture. A ``Graph`` then captures the function over
static input buffers, with a private memory pool for its intermediates; a
replay copies the inputs into those buffers, launches the graph and returns a
copy of the static output (a caller may keep the outputs of earlier
replays). Each capture adds the kernel launches it recorded to
``kernels.CAPTURED`` and each replay adds them to ``kernels.REPLAYED``, so
``kernels.executions()`` counts the kernels that ran on every route. A capture
or replay that fails raises: there is no eager fallback on the card.

K train steps a graph are the counterpart of the JAX ``Trainer``'s
``_get_train_scan`` and ``_train_epoch_chunked`` (TRAIN.STEPS_PER_DISPATCH =
K > 1): where JAX scans the raw step over a (K, B) index chunk in one compiled
program, ``ChunkRunner`` captures one graph per chunk length (K, and the
epoch's remainder). A graph holds L copies of the pipeline's step body: copy j
reads row j of the static (L, B) int64 index buffer, gathers its batch from
the device-resident train set (``gather``), runs the train step as it is (for
Voice2Pose: the mel kernel, the generator's train forward, L1 + KL, backward,
both Adams, the pose encoder's BN drift, the metrics) and writes its losses
into row j of a static (L, n) output. The first chunk of a run is the warm-up,
real steps of the schedule; the next chunk of each length is captured, then
replayed; every later one is replayed. The train state must be built
``capturable`` (Adams with device-side bias correction and tensor learning
rates), and its noise generator is registered with each graph, so replays
draw what eager steps would. The caller stages each epoch's index schedule on
the device once (``index_tensor``); a chunk is a slice of it, and a replay's
only copy is that slice into the graph's index buffer, on the card.

On the CPU there is no graph: ``run`` takes the same chunks through the step
eagerly, so the chunk schedule, its logging and its preemption checks are
the same on both.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import kernels
from ..utils import trace


def warm_up(fn, inputs: tuple, stream: torch.cuda.Stream):
    """``fn(*inputs)`` run eagerly on ``stream``, after the work queued on the
    caller's stream and before what the caller queues next. The inputs are
    marked in use on ``stream`` and the output on the caller's stream, so the
    allocator reuses neither's memory while the other stream may still read
    it. ``None`` inputs pass through."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn(*inputs)
    cur.wait_stream(stream)
    for t in inputs:
        if t is not None:
            t.record_stream(stream)
    out.record_stream(cur)
    return out


class Graph:
    """``fn`` captured on ``stream`` over static copies of ``inputs``
    (``None`` stays ``None``), once ``warm_up`` has run it; ``generators`` are
    registered with the graph, so each replay draws what an eager run would.
    ``graph(*inputs)`` replays it on the caller's stream."""

    def __init__(self, fn, inputs: tuple, stream: torch.cuda.Stream, generators=()):
        self.inputs = tuple(None if t is None else torch.empty_like(t) for t in inputs)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = collections.Counter(kernels.LAUNCHES)
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(*self.inputs)
        self.launches = collections.Counter(kernels.LAUNCHES) - before
        kernels.CAPTURED.update(self.launches)

    def __call__(self, *inputs) -> torch.Tensor:
        for static, t in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(t)
        self.graph.replay()
        kernels.REPLAYED.update(self.launches)
        return self.out.clone()


def gather(cache, idx: torch.Tensor):
    """A batch of the device-resident train set: rows ``idx`` of every
    tensor (``speaker_stat`` nested)."""
    if isinstance(cache, dict):
        return {k: gather(v, idx) for k, v in cache.items()}
    return cache.index_select(0, idx)


def index_tensor(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int64 index array on ``device``; to the card from page-locked
    memory, so the host does not wait for the queue to reach the copy (the
    host allocator keeps the buffer until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class ChunkRunner:
    """Runs chunks of train steps on batches gathered from ``cache`` (the
    staged train set), as CUDA graphs on the card (``graphed``) or eagerly.
    ``run`` takes an (L, B) int64 index tensor on the device and returns the
    chunk's losses as an (L, n) tensor whose columns are ``names``."""

    def __init__(self, state, step_fn, cache: Dict[str, object], graphed: bool):
        if graphed and not state.capturable:
            raise ValueError("CUDA-graph chunks need a train state built capturable")
        self.state, self.step_fn, self.cache = state, step_fn, cache
        self.names: Optional[List[str]] = None
        self.graphs: Dict[int, Graph] = {}
        self.stream = torch.cuda.Stream(state.device) if graphed else None
        self.warm = False

    def _rows(self, idx: torch.Tensor) -> torch.Tensor:
        rows = []
        for j in range(idx.shape[0]):
            losses, _ = self.step_fn(self.state, gather(self.cache, idx[j]))
            if self.names is None:
                self.names = list(losses)
            rows.append(torch.stack([losses[k].float() for k in self.names]))
        return torch.stack(rows)

    def run(self, chunk: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return self._rows(chunk)
        if not self.warm:
            with trace.span("chunk.warm"):
                out = warm_up(self._rows, (chunk,), self.stream)
            self.warm = True
            return out
        g = self.graphs.get(len(chunk))
        if g is None:
            with trace.span("chunk.capture"):
                step = self.state.step
                g = self.graphs[len(chunk)] = Graph(self._rows, (chunk,), self.stream,
                                                    (self.state.rng,))
                self.state.step = step  # the capture ran no step
        with trace.span("chunk.replay"):
            self.state.step += len(chunk)
            return g(chunk)
