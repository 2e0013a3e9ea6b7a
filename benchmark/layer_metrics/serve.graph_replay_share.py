"""The share of the window's serving calls that replayed a CUDA graph, in %:
100 x the port's ``serve.forward`` spans that open in the traced window and
hold a ``serve.replay`` span, over the ``serve.forward`` spans that open in it
(``speechdrivestemplates_tpu_torch/serving.py``; a forward recorded while a
graph captured is host code run once, not a call, and is not counted). None
where no ``serve.forward`` span opens in the window, or where the port has no
graphed serving route to record a replay."""


def read(ctx):
    try:
        from speechdrivestemplates_tpu_torch import serving
        from speechdrivestemplates_tpu_torch.utils import trace
    except ImportError:
        return None
    if not hasattr(serving, "ServingFn"):
        return None
    rec = trace.RECORDER
    calls = {i for i, (name, a, _, _) in enumerate(rec.rows)
             if name == "serve.forward" and ctx["t0"] <= a < ctx["t1"] and not rec.captured[i]}
    if not calls:
        return None
    replayed = {rec.parents[i] for i, row in enumerate(rec.rows)
                if row[0] == "serve.replay" and rec.parents[i] in calls}
    return 100.0 * len(replayed) / len(calls)
