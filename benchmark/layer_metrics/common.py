"""Arithmetic the readers share: shares of the peak and of a roofline."""

from benchmark import counts, tracing


def mfu(ctx, flops_key: str):
    flops = ctx["config"].get("flops", {}).get(flops_key)
    if not flops or not ctx["work"].get("clips"):
        return None
    rate = flops * ctx["work"]["clips"] / ctx["window_s"]
    return 100.0 * rate / counts.PEAKS["H100_SXM"]["bf16_flops_per_s"]


def idle_share(ctx):
    if ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def roofline(ctx, layer: str, count_fn):
    """100 x the least time of one call of ``layer`` over its device time per
    call in the window; None where the layer's kernels did not run."""
    seconds = tracing.group_seconds(ctx["rows"], layer)
    calls = ctx["work"].get("calls", 0)
    if seconds <= 0 or not calls:
        return None
    flops, nbytes = count_fn(ctx["work"]["batch"], ctx["work"]["samples"])
    return 100.0 * counts.bound_s(flops, nbytes) / (seconds / calls)
