"""Spans at the port's layer boundaries, recorded while a ``torch.profiler``
session runs.

``span(name)`` is a context manager. With no profiler session running
(``torch.autograd.profiler._is_profiler_enabled`` false) it returns one shared
no-op context: nothing is allocated, recorded or called on the card. During a
session (the benchmark's traced window, the trainer's SYS.PROFILE window) each
span records into ``RECORDER``:

- ``rows``: ``[name, start_ns, end_ns, request]`` on ``time.perf_counter_ns``,
  the layout and clock of ``benchmark/tracing.py::Spans.rows``; ``request``
  numbers the outermost spans, and a span inside one carries its number;
- ``parents``: the index of the row open around each, -1 at the top;
- ``captured``: whether the current stream was capturing a CUDA graph when
  the span opened (its host code then runs once, at capture, not at replay);
- ``device_ns``: once ``resolve()`` has run, the time the card reached the
  span's start marker, on the same host clock (None without a marker).

The start marker is a timing CUDA event recorded on the current stream as the
span opens, none under a capture or before CUDA is initialized. The first
marker synchronizes the card once and records an anchor event beside a host
time; ``resolve()`` synchronizes, records a closing anchor the same way, and
places every marker between the two on the host clock. A marker's device time
minus its span's host start is the host's lead over the card at that point:
a few microseconds where the card waits on the host, the queue's depth where
the host runs ahead.

Spans open and close on one thread. Rows stop at ``cap``; ``dropped`` counts
the spans not recorded. No ``record_function`` range is opened: under a
CUDA-only profiler such ranges can come back as device rows.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import nullcontext
from typing import List, Optional

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 16
_OFF = nullcontext()
# the thread id of the spans' row in a Chrome trace: above any Linux thread id
CHROME_TID = 1 << 30


class _Span:
    __slots__ = ("rec", "name", "row", "open")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.open = rec.open  # the stack of this recording, should reset() start another
        if self.open:
            parent = self.open[-1]
            request = rec.rows[parent][3]
        else:
            parent, request = -1, rec.requests
            rec.requests += 1
        marker, captured = None, False
        if torch.cuda.is_initialized():
            # (stream id, device, type); id 0, the default stream, never captures
            key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
            captured = key[0] != 0 and torch.cuda.is_current_stream_capturing()
            if not captured:
                marker, stream = rec.marker(key)
        i = len(rec.rows)
        self.row = [self.name, time.perf_counter_ns(), -1, request]
        if marker is not None:
            marker.record(stream)
            rec.markers[i] = marker
        rec.rows.append(self.row)
        rec.parents.append(parent)
        rec.captured.append(captured)
        rec.device_ns.append(None)
        self.open.append(i)
        return self

    def __exit__(self, *exc) -> bool:
        self.row[2] = time.perf_counter_ns()
        self.open.pop()
        return False


class Recorder:
    """The spans of one process: see the module's docstring."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.reset()

    def reset(self) -> None:
        """Clear the rows, the anchor and the pool of marker events."""
        self.rows: List[list] = []
        self.parents: List[int] = []
        self.captured: List[bool] = []
        self.device_ns: List[Optional[int]] = []
        self.dropped = 0
        self.requests = 0
        self.open: List[int] = []
        self.markers = {}  # row index -> its start marker, until resolve()
        self.pool: List[torch.cuda.Event] = []
        self.streams = {}  # current-stream key -> its Stream, made once
        self.anchor = None  # (event, host ns)
        # host ns per device ns between the two anchors, from the last resolve()
        self.clock_ratio = 1.0
        self.unix_offset_ns = time.time_ns() - time.perf_counter_ns()

    def span(self, name: str):
        if len(self.rows) >= self.cap:
            self.dropped += 1
            return _OFF
        return _Span(self, name)

    def marker(self, key: tuple):
        """A timing event from the pool, and the stream ``key`` names
        (``torch.cuda.current_stream()`` costs a few microseconds a call); the
        first marker of a recording first synchronizes the card and records
        the anchor."""
        if self.anchor is None:
            self.anchor = self._anchor_now()
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return (self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)), stream

    @staticmethod
    def _anchor_now():
        """An event recorded on an idle card, and the host time at the middle
        of the record call: the card reaches it as the record arrives. The
        event is made (by a first record) before, so the call only enqueues."""
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        event.record()
        return event, (t0 + time.perf_counter_ns()) // 2

    def resolve(self) -> None:
        """Give every marker recorded since the last call its device time on
        the host clock (``device_ns``) and return its event to the pool.
        Synchronizes the card."""
        if not self.markers:
            return
        anchor, host0 = self.anchor
        end, host1 = self._anchor_now()
        end.synchronize()
        span_ms = anchor.elapsed_time(end)
        if span_ms > 0:
            self.clock_ratio = (host1 - host0) / (span_ms * 1e6)
        for i, event in self.markers.items():
            self.device_ns[i] = host0 + round(anchor.elapsed_time(event) * 1e6 * self.clock_ratio)
            self.pool.append(event)
        self.markers = {}


RECORDER = Recorder()


def span(name: str):
    """A span named ``name`` in ``RECORDER`` while a profiler session runs,
    else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return RECORDER.span(name)


def resolve() -> None:
    RECORDER.resolve()


def add_to_chrome_trace(path: str) -> int:
    """Append ``RECORDER``'s closed spans to the Chrome trace at ``path``, as
    ``torch.profiler`` exported it: complete events on a row of their own in
    this process, on the trace's clock (Unix microseconds less the file's
    ``baseTimeNanoseconds``), each with its request, its parent's index, whether
    it was captured and, where it had a marker, the host's lead over the card
    in microseconds. Returns how many spans went in."""
    rec = RECORDER
    rec.resolve()
    with open(path) as f:
        doc = json.load(f)
    shift = rec.unix_offset_ns - doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": CHROME_TID,
                   "args": {"name": "port spans"}})
    n = 0
    for i, (name, start, end, request) in enumerate(rec.rows):
        if end < 0:
            continue
        args = {"request": request, "parent": rec.parents[i], "captured": rec.captured[i]}
        if rec.device_ns[i] is not None:
            args["lead_us"] = (rec.device_ns[i] - start) / 1e3
        events.append({"ph": "X", "cat": "port_span", "name": name, "pid": pid,
                       "tid": CHROME_TID, "ts": (start + shift) / 1e3,
                       "dur": (end - start) / 1e3, "args": args})
        n += 1
    with open(path, "w") as f:
        json.dump(doc, f)
    return n


def reset() -> None:
    RECORDER.reset()
