"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks for:
set-up (the port's kernels built into the checkout's ``build/`` or loaded
from there, the seeded weights and inputs made on the card, every shape the
cell's traffic uses warmed), then the measured window of ``--seconds``, then
the check against the plain reference. With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiler trace of the window (then at most ``TRACE_SECONDS`` long) and
the benchmark's host spans (kept in memory, written under TMPDIR at the end). The numbers compared with the
reference and their limits come last, on standard error and under "checks".
Without a card, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# run as a script, this folder heads sys.path: its modules are imported as
# the package ``benchmark`` from the checkout's root instead
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "speechdrivestemplates_tpu")
# a traced window is at most this long: the profiler keeps every kernel and
# launch (~700 a serving call), and reading millions of them would outlast a run
TRACE_SECONDS = 10.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def read_layer_metrics(cell: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    from benchmark import spec

    out = {}
    for m in cell["per_layer"]:
        loader = importlib.util.spec_from_file_location(f"layer_metric_{len(out)}",
                                                        spec.metric_path(m["name"]))
        module = importlib.util.module_from_spec(loader)
        loader.loader.exec_module(module)
        value = module.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of ``cell``; the result's dictionary. The card's presence is
    the caller's to check."""
    import torch

    from benchmark import correct, drivers, tracing

    torch.set_num_threads(4)
    spans = tracing.Spans()
    driver = drivers.make(cell, seed, device, spans)
    driver.setup()
    win = tracing.Window(traced, device)
    setup_s = time.perf_counter() - T_START
    values = driver.window(min(seconds, TRACE_SECONDS) if traced else seconds, win)
    values["setup_s"] = setup_s
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"loaded after the window: {loaded}")
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    out = {"attempted": values["attempted"], "failed": 0}
    if traced:
        red = tracing.reduce(win.device_events(), spans, win)
        ctx = {"cell": cell, "config": cell["config_file"], "traffic": cell["traffic_file"],
               "work": driver.work, "window_s": win.seconds, "busy_s": red["busy_s"],
               "rows": red["rows"], "spans": spans, "t0": win.t0, "t1": win.t1}
        out["metrics"] = read_layer_metrics(cell, ctx)
        device_info.update(busy_s=red["busy_s"], window_s=win.seconds)
        out["breakdown"] = red["breakdown"]
        win.prof = None
    else:
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell["end_to_end"]}
    spans.dump(f"{cell['name']}.{seed}.{int(traced)}")
    driver.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, checks = correct.judge(driver.check(), cell["limits"])
    out["correct"] = ok
    out["device"] = device_info
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    sys.path.insert(0, ROOT)
    from benchmark import spec

    cell = spec.cell(spec.load(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
