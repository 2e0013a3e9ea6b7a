"""The numbers ``correct.py`` compares for faults of the program, on the
card, at the cell's own size, many seeds in one process:

    python3 benchmark/calibrate_faults.py --workload <cell> --seeds 1,2,... \
        [--seconds 1] [--out FILE]

A fault is a context of the configuration's model module (``FAULTS``) that
alters the port while the cell is set up and run; each must read over a limit
of ``limits/<cell>.json`` on every seed. One JSON line a reading, as
``calibrate.py`` prints them, its ``kind`` the fault's name, and ``correct``
as the cell's limits judge it.
"""

import argparse
import json
import os
import sys

sys.path[:1] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/calibrate_faults.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from benchmark import correct, drivers, spec, tracing

    cell = spec.cell(spec.load(sys.path[0]), args.workload)
    faults = drivers.load_model(cell["config_file"]).FAULTS
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in sorted(faults):
            with faults[name]():
                d = drivers.make(cell, seed, "cuda", tracing.Spans())
                d.setup()
                d.window(args.seconds, tracing.Window(False, "cuda"))
                d.free()
            numbers = d.check(False)
            ok, _ = correct.judge(numbers, cell["limits"])
            line = json.dumps({"cell": args.workload, "seed": seed, "kind": name,
                               "numbers": dict(numbers), "correct": ok})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del d
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
