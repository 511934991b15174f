"""The readings that a cell's limit is set from, in one process.

    python3 tnbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 3] [--device cuda]

For each seed: the cell's set-up and a short window at its own load,
exactly as a run makes them, then the check's number for the program's
sampled calls (the lower reading is the largest over the seeds) and,
on the control seeds, for the control: the plain reference in the
precision below the configuration's (``"control"`` in its file: TF32
for float32 with TF32 off), put in the program's place on the same
calls (the upper reading is the smallest). Prints one JSON line per
seed and a summary line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(root, name, seeds, control_seeds, seconds, device):
    import torch

    from tnbench import harness

    cell = harness.resolve_cell(root, name)
    dev = torch.device(device)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        spans = harness.Spans()
        session, sets, inputs, output, size_dict, k = harness.setup(cell, seed, dev, spans)
        calls, window_s, _ = harness.window(session, k, seconds, spans)
        harness.free_program(session)
        controls = [cell.config["control"]] if seed in control_seeds else []
        worst, compared = harness.judge(
            cell, session, calls, sets, inputs, output, size_dict, dev, seed, controls
        )
        row = {
            "seed": seed, "program": worst["program"],
            "control": worst.get(0), "compared": compared,
            "window_calls": len(calls), "failed": sum(1 for c in calls if not c.ok),
            "seconds": time.perf_counter() - t0,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        del session, sets
        harness.free_memory()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = readings(ROOT, args.workload, seeds, control, args.seconds, args.device)
    lower = max(r["program"] for r in rows)
    ctl = [r["control"] for r in rows if r["control"] is not None]
    print(json.dumps({
        "workload": args.workload, "seeds": len(rows), "lower": lower,
        "upper": min(ctl) if ctl else None, "control_seeds": len(ctl),
        "failed": sum(r["failed"] for r in rows),
    }), flush=True)


if __name__ == "__main__":
    main()
