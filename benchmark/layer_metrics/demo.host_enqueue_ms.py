"""The median host time, in ms, from a request's start (the demo batch
built) until ``demo_step`` returns, before the copy to the host waits for the
card; from the benchmark's spans in the traced window."""

import statistics


def read(ctx):
    start, end = {}, {}
    for name, a, b, r in ctx["spans"].rows:
        if r < 0 or not ctx["t0"] <= a < ctx["t1"]:
            continue
        if name == "batch_build":
            start[r] = a
        elif name == "demo_step":
            end[r] = b
    times = [(end[r] - start[r]) / 1e6 for r in end if r in start]
    return statistics.median(times) if times else None
