"""The readings that a cell's limits (``limits/<cell>.json``) are set from,
on the card, at the cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 1] [--out FILE]

For each seed: the cell's set-up and a short window, then the numbers
``correct.py`` compares for the program; on a control seed also for the
control (the reference in fp8 put in the program's place) and, in a training
cell, for the fault of half of each batch left out (the reference stepping
on the first half of each batch's rows). One JSON line a reading. The
benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys

sys.path[:1] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def half_batch_readings(d) -> list:
    """A training cell's numbers with half of each of the first three batches
    left out, the mean taken over the rest, against the full reference."""
    import torch

    from benchmark import correct

    full, half = [], []
    for rows in d.setup_rows[:3]:
        idx = torch.as_tensor(rows, device=d.device)
        b = {k: d.cache[k][idx] for k in ("audio", "poses", "clip_index")}
        full.append(b)
        half.append({k: v[: len(rows) // 2] for k, v in b.items()})
    ref = d.mm.reference_steps(d.weights, d.bank0, full, d.model)
    fault = d.mm.reference_steps(d.weights, d.bank0, half, d.model)
    return correct.train_numbers(fault, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from benchmark import drivers, spec, tracing

    root = sys.path[0]
    cell = spec.cell(spec.load(root), args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        d = drivers.make(cell, seed, "cuda", tracing.Spans())
        d.setup()
        d.window(args.seconds, tracing.Window(False, "cuda"))
        d.free()
        torch.cuda.empty_cache()
        lines = [("program", d.check(False))]
        if seed in controls:
            lines.append(("control", d.check(True)))
            if cell["traffic_file"]["kind"] == "train_cache":
                lines.append(("half_batch", half_batch_readings(d)))
        for kind, numbers in lines:
            line = json.dumps({"cell": args.workload, "seed": seed, "kind": kind,
                               "numbers": dict(numbers)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
