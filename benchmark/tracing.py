"""Host spans kept in memory, the profiler's window, and their reduction:
kernel rows by name, device busy time, and the breakdown of a traced run.

Spans are the benchmark's own, around each call into a layer of the port:
``(name, start_ns, end_ns, request)`` on the host's clock, with the offset to
the Unix clock that the profiler's events carry. The profiler traces the
card's activity only (``ProfilerActivity.CUDA``); busy time is the union of
the kernels', copies' and sets' intervals inside the traced window, whose
length the host clock gives around two synchronizations."""

import json
import os
import re
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

# the port's kernels (csrc/*.cu, anonymous namespaces) by layer
PORT_KERNELS = {"mel_kernel": "B1 mel", "conv1_gram_kernel": "B3 conv1+IN1",
                "conv1_apply_kernel": "B3 conv1+IN1", "conv_ring_kernel": "B2 stem",
                "conv_in_kernel": "B2 stem", "finalize_kernel": "B2 stem",
                "apply_kernel": "B2 stem"}
_PORT = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+)")
# the breakdown's kinds of library kernels: name fragments, first match wins
KINDS = (("dgrad", "cuDNN conv backward, data"), ("wgrad", "cuDNN conv backward, weights"),
         ("fprop", "cuDNN conv forward"), ("multi_tensor_apply", "Adam updates"),
         ("Memcpy", "copies"), ("Memset", "memsets"))
OTHER = "other: elementwise, reductions, copies, layouts"


def port_layer(name: str) -> Optional[str]:
    m = _PORT.match(name)
    return PORT_KERNELS.get(m.group(1)) if m else None


def kind_of(name: str) -> str:
    return port_layer(name) or next((k for frag, k in KINDS if frag in name), OTHER)


class Spans:
    """Host spans of one run, in memory; ``dump`` writes them under TMPDIR."""

    def __init__(self):
        self.rows: List[Tuple[str, int, int, int]] = []
        self.unix_offset = time.time_ns() - time.perf_counter_ns()

    @contextmanager
    def span(self, name: str, request: int = -1):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.rows.append((name, t0, time.perf_counter_ns(), request))

    def dump(self, tag: str) -> str:
        path = os.path.join(tempfile.gettempdir(), "sdt_benchmark_spans", f"{tag}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"unix_offset_ns": self.unix_offset, "spans": self.rows}, f)
        return path


class Window:
    """The traced window: ``start`` and ``stop`` synchronize the card and read
    the host clock; between them the profiler records the card's activity."""

    def __init__(self, traced: bool, device):
        self.traced, self.device = traced, torch.device(device)
        self.prof = None
        self.t0 = self.t1 = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if self.traced and self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter_ns()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device_events(self) -> List[Tuple[str, int, int]]:
        """(name, start, end) in Unix ns of every operation on the card."""
        if self.prof is None:
            return []
        cuda = torch.autograd.DeviceType.CUDA
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == cuda and e.duration_ns() > 0]


def reduce(events: List[Tuple[str, int, int]], spans: Spans, window: Window) -> dict:
    """Kernel rows, busy seconds inside the window, and the breakdown."""
    lo = window.t0 + spans.unix_offset
    hi = window.t1 + spans.unix_offset
    rows: Dict[str, List[float]] = {}
    intervals = []
    for name, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        r = rows.setdefault(name, [0.0, 0])
        r[0] += (b - a) / 1e9
        r[1] += 1
        intervals.append((a, b))
    intervals.sort()
    busy, gaps, cur_a, cur_b = 0, [], lo, lo
    for a, b in intervals:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a = a
        cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if hi > cur_b:
        gaps.append((cur_b, hi))
    kinds: Dict[str, float] = {}
    for name, (sec, _) in rows.items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + sec
    device_ops = sorted(([k, v] for k, v in kinds.items() if k != OTHER), key=lambda r: -r[1])
    others = sorted(([n[:100], s] for n, (s, _) in rows.items() if kind_of(n) == OTHER),
                    key=lambda r: -r[1])
    device_ops = sorted(device_ops + others[: max(0, 10 - len(device_ops))],
                        key=lambda r: -r[1])[:10]
    return {"rows": rows, "busy_s": busy / 1e9,
            "breakdown": {"device_ops": device_ops,
                          "idle_gaps": idle_gaps(gaps, spans)}}


def idle_gaps(gaps: List[Tuple[int, int]], spans: Spans) -> List[list]:
    """Idle seconds of the card, summed by the innermost span open on the
    host when each gap began ("between spans" where none was)."""
    rows = sorted((a + spans.unix_offset, b + spans.unix_offset, n) for n, a, b, _ in spans.rows)
    by: Dict[str, float] = {}
    j, open_ = 0, []
    for a, b in sorted(gaps):
        while j < len(rows) and rows[j][0] <= a:
            open_.append(rows[j])
            j += 1
        open_ = [r for r in open_ if r[1] > a]
        label = min(open_, key=lambda r: r[1] - r[0])[2] if open_ else "between spans"
        by[label] = by.get(label, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda r: -r[1])[:10]


def group_seconds(rows: Dict[str, List[float]], layer: str) -> float:
    """Device seconds of one port layer's kernels."""
    return sum(s for name, (s, _) in rows.items() if port_layer(name) == layer)
