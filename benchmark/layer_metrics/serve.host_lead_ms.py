"""The host's lead over the card at a serving call's start, in ms: the median,
over the port's ``serve.forward`` spans that open in the traced window, of the
time the card reached the span's start marker less the span's host start
(``speechdrivestemplates_tpu_torch/utils/trace.py``). A few microseconds where
the card waits on the host at every call; the depth of the host's queue where
it runs ahead. None where the port records no such span or marker."""

import statistics


def read(ctx):
    try:
        from speechdrivestemplates_tpu_torch.utils import trace
    except ImportError:
        return None
    trace.resolve()
    rec = trace.RECORDER
    leads = [(rec.device_ns[i] - a) / 1e6 for i, (name, a, _, _) in enumerate(rec.rows)
             if name == "serve.forward" and ctx["t0"] <= a < ctx["t1"]
             and rec.device_ns[i] is not None]
    return statistics.median(leads) if leads else None
