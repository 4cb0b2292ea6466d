"""The control of `correct`, and the faults' readings: the plain
reference computed in TF32, the precision next below the float32 the
configurations state, put in the program's place; or the program with a
fault of benchmark/faults.py planted in its timed path. Not part of any
benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 10] [--faults all|<name>,<name>]

For each seed, one run of the cell at its own size (benchmark.run.measure:
its set-up, warm-up and a window of --seconds), then the compared numbers
twice over the waves it captured: the program's and the control's, each
against the schedule and the float64 reference; with --faults, once more
a run for each fault the cell's renderer can have. Prints one JSON line a
run and one with the extremes: the lower readings (the program's largest)
and the upper (the least of the control's and of each fault's) from which
the cell's limits are set."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(cell, seeds, seconds: float, device, fault=None):
    """[(seed, program's numbers, control's numbers)] of the seeds; with
    `fault`, the name of one in benchmark/faults.py, the program's
    numbers with it planted, and no control."""
    import torch

    from benchmark import faults, judge, reference
    from benchmark.run import measure
    out = []
    for seed in seeds:
        run, frames, plain = measure(
            cell, seed, seconds, False, device, time.perf_counter(),
            fault=faults.FAULTS[fault][0] if fault else None)
        tris = torch.from_numpy(reference.world_triangles(plain)).to(device)
        sched = judge.schedule(cell.traffic)
        shown = []
        out.append((seed, judge.numbers(frames, tris, sched, shown=shown),
                    None if fault else
                    judge.numbers(frames, tris, sched, answer="control")))
        for ray in shown if not fault else ():
            print("ray off:", json.dumps(ray), file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from benchmark import faults
    from benchmark.run import load_cell
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = torch.device("cuda", 0)
    rows = readings(cell, seeds, args.seconds, dev)
    uppers = {"control": [c for _, _, c in rows]}
    names = (faults.for_renderer(cell.config["renderer"])
             if args.faults == "all" else
             [f for f in args.faults.split(",") if f])
    for name in names:
        uppers[name] = [p for _, p, _ in
                        readings(cell, seeds, args.seconds, dev, name)]
    for seed, prog, ctrl in rows:
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": prog, "control": ctrl}), flush=True)
    for name in names:
        for seed, nums in zip(seeds, uppers[name]):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "fault": name, "program": nums}), flush=True)
    keys = rows[0][1].keys()
    print(json.dumps({
        "workload": cell.name, "device": torch.cuda.get_device_name(0),
        "lower": {n: max(p[n] for _, p, _ in rows) for n in keys},
        "upper": {src: {n: min(r[n] for r in rs) for n in keys}
                  for src, rs in uppers.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
