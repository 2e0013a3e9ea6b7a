"""Per-layer metric readers, one file a metric named as in ``BENCHMARK.json``.

Each file defines ``read(ctx)``: the metric's value from the traced run, or
None where its cell gives it nothing to read (then the metric is left out of
the line). ``ctx``: ``config`` and ``traffic`` (the cell's files), ``work``
(the driver's counts: ``calls``, ``clips``, ``batch``, ``samples``),
``window_s`` and ``busy_s`` (the traced window and the card's busy time in
it), ``rows`` (device seconds and count of each kernel name in the window),
``spans`` (the host spans), ``t0``/``t1`` (the window on the host clock, ns).
Helpers shared by readers live in ``common.py``.
"""
