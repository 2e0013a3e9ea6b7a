"""K train steps in one CUDA graph, fed from the train set on the card.

Counterpart of the JAX ``Trainer``'s ``_get_train_scan`` and
``_train_epoch_chunked`` (TRAIN.STEPS_PER_DISPATCH = K > 1): where JAX scans
the raw step over a (K, B) index chunk in one compiled program, the port
captures one ``torch.cuda.CUDAGraph`` per chunk length (K, and the epoch's
remainder). A graph holds L copies of the pipeline's step body: copy j reads
row j of a static (L, B) int64 index buffer, gathers its batch from the
device-resident train set (``gather``), runs the train step as it is (for
Voice2Pose: the mel kernel, the generator's train forward, L1 + KL, backward,
both Adams, the pose encoder's BN drift, the metrics) and writes its losses
into row j of a static (L, n) output.

Capture records and runs nothing, so the first chunk of a run runs eagerly as
real steps of the schedule, on the stream that captures next: it builds every
lazily made constant (the mel kernel's tables, the resize matrices, the pose
index tables, the optimizers' state, the handles' workspaces) before a capture
could try to copy one from host memory, and makes the kernels' one-time
``cudaFuncSetAttribute`` calls (``csrc/mel.cu``, ``conv1.cu`` and ``stem.cu``
make it at their first launch in a process), so none happens under capture. The next chunk of each length is
captured, then replayed; every later one is replayed. The train state must be
built ``capturable`` (Adams with device-side bias correction and tensor
learning rates), and its noise generator is registered with each graph, so
replays draw what eager steps would. A capture or replay that fails raises:
there is no eager fallback on the card. The caller stages each epoch's index
schedule on the device once (``index_tensor``); a chunk is a slice of it, and
a replay's only copy is that slice into the graph's index buffer, on the card.

On the CPU there is no graph: ``run`` takes the same chunks through the step
eagerly, so the chunk schedule, its logging and its preemption checks are
the same on both.
"""

from __future__ import annotations

import collections
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import kernels
from ..utils import trace


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
        self.graphed = graphed
        self.names: Optional[List[str]] = None
        self.graphs: Dict[int, SimpleNamespace] = {}
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
        dev = self.state.device
        if not self.graphed:
            return self._rows(chunk)
        if not self.warm:  # real steps on the capture stream: lazy constants, workspaces
            with trace.span("chunk.warm"):
                self.stream.wait_stream(torch.cuda.current_stream(dev))
                chunk.record_stream(self.stream)
                with torch.cuda.stream(self.stream):
                    out = self._rows(chunk)
                torch.cuda.current_stream(dev).wait_stream(self.stream)
            self.warm = True
            return out
        g = self.graphs.get(len(chunk))
        if g is None:
            with trace.span("chunk.capture"):
                g = self._capture(len(chunk), chunk.shape[1])
        with trace.span("chunk.replay"):
            g.idx.copy_(chunk)
            g.graph.replay()
            kernels.REPLAYED.update(g.launches)
            self.state.step += len(chunk)
            return g.out.clone()

    def _capture(self, length: int, batch: int) -> SimpleNamespace:
        dev, state = self.state.device, self.state
        idx = torch.zeros((length, batch), dtype=torch.int64, device=dev)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.rng)
        before, step0 = collections.Counter(kernels.LAUNCHES), state.step
        with torch.cuda.graph(graph, stream=self.stream):
            out = self._rows(idx)
        state.step = step0  # the capture ran no step
        launches = collections.Counter(kernels.LAUNCHES)
        launches.subtract(before)
        launches = +launches
        kernels.CAPTURED.update(launches)
        self.graphs[length] = g = SimpleNamespace(graph=graph, idx=idx, out=out,
                                                  launches=launches)
        return g
