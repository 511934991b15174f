#!/usr/bin/env python3
"""Fit ``cotengra_tpu_torch/ops/simulate.py``'s ``H100_CONSTANTS`` to the
warm times that ``chip_smoke.py`` (or ``scratch/vmap_phases.py``)
measured on the card.

    python scratch/sim_calibrate_gpu.py <log of the card run>

Reads the log's ``{"calibration": {"card": ..., "runs": [...]}}`` line
and rebuilds each run's tree on the host (the committed plans through
the port; the example's m10 tree sliced to 2^22 as phase 34 plans it).
It prices each tree's planned steps once (``step_records``) and fits
the rates and host costs by least squares on log(model / measured) to
the runs of the calibration set (``"fit": true``), one constants table
for every run; the chain kernel's byte rate is not fitted but read from
the same log (phase 31: bytes over the batched kernel's ms). Prints the
fitted table and the ``H100_MEASURED`` literal to commit, then each
run's measured and modelled seconds, the held-out runs marked.
Runs on the CPU in about a minute (the m=20 instance and the 2^22 plan).
"""

import json
import math
import sys
from pathlib import Path

import numpy as np
from scipy.optimize import least_squares

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cotengra_tpu_torch.ops.simulate import (  # noqa: E402
    H100_CONSTANTS,
    price,
    step_records,
)

# the constants fitted (in log space); the others keep their values
FITTED = ("chain_gflops", "copy_gbps", "dot_gbps", "gemm_tflops",
          "einsum_gbps", "step_s", "launch_s", "kernel_s",
          "slice_overhead_s")
# bounds: rates no faster than the card's published peaks (3.35 TB/s of
# HBM, 67 TFLOP/s float32), host costs between 1 us and 1 ms
BOUNDS = {
    "chain_gflops": (1000.0, 67000.0), "copy_gbps": (100.0, 3350.0),
    "dot_gbps": (100.0, 3350.0), "gemm_tflops": (5.0, 67.0),
    "einsum_gbps": (10.0, 3350.0), "step_s": (1e-6, 1e-3),
    "launch_s": (1e-7, 1e-4), "kernel_s": (1e-7, 1e-4),
    "slice_overhead_s": (1e-6, 1e-2),
}


def _calibration(log):
    for line in reversed(Path(log).read_text().splitlines()):
        if line.startswith('{"calibration"'):
            return json.loads(line)["calibration"]
    raise SystemExit(f"no calibration line in {log}")


def _chain_gbps(log):
    """The chain kernel's rate, measured: phase 31's 13 t27 chains at 4
    slices, bytes (their bound at 3.35 TB/s) over the kernel's ms."""
    for line in Path(log).read_text().splitlines():
        if line.startswith("# vmap chains t27"):
            words = line.split()
            ms = float(words[words.index("batched") + 1])
            bound = float(words[words.index("bound") + 1])
            return 3350.0 * bound / ms
    raise SystemExit(f"no batched t27 chain line in {log}")


def _tree(plan, cache):
    if plan not in cache:
        if plan == cs.SMALL_SLICE_PLAN:
            committed = cs._load_instance(cs.T27)[0]
            cache[plan] = cs._small_slices_tree(committed)[0]
        else:
            cache[plan] = cs._load_instance(plan)[0]
    return cache[plan]


def _model(rec, run, consts):
    nsl = run["nslices"] if run["nslices"] != rec["nslices"] else None
    return price(rec, consts, run["slice_batch"], run["mode"] or "auto",
                 nsl)


def main():
    cal = _calibration(sys.argv[1])
    runs = [r for r in cal["runs"] if r.pop("fit", True)]
    held = [r for r in _calibration(sys.argv[1])["runs"]
            if not r.pop("fit", True)]
    trees, records = {}, {}
    for r in runs + held:
        if r["plan"] not in records:
            records[r["plan"]] = step_records(_tree(r["plan"], trees))

    chain = _chain_gbps(sys.argv[1])

    def consts_of(p):
        return dict(H100_CONSTANTS, chain_gbps=chain, **{
            k: math.exp(v) for k, v in zip(FITTED, p)
        })

    def residuals(p):
        c = consts_of(p)
        return [
            math.log(_model(records[r["plan"]], r, c) / r["seconds"])
            for r in runs
        ]

    p0 = [math.log(H100_CONSTANTS[k]) for k in FITTED]
    lo = [math.log(BOUNDS[k][0]) for k in FITTED]
    hi = [math.log(BOUNDS[k][1]) for k in FITTED]
    p0 = np.clip(p0, np.add(lo, 1e-9), np.subtract(hi, 1e-9))
    fit = least_squares(residuals, p0, bounds=(lo, hi))
    c = consts_of(fit.x)
    print("H100_CONSTANTS = {")
    for k, v in c.items():
        print(f"    {k!r}: {float(f'{v:.4g}')!r},")
    print("}")
    print("H100_MEASURED = " + json.dumps(
        {"card": cal["card"], "runs": runs}, indent=1))
    worst = 0.0
    for r in runs + held:
        m = _model(records[r["plan"]], r, c)
        err = m / r["seconds"] - 1
        if r in runs:
            worst = max(worst, abs(err))
        print(f"# {r['plan']} batch {r['slice_batch']} mode {r['mode']} "
              f"slices {r['nslices']}: measured {r['seconds']:.4f} s model "
              f"{m:.4f} s ({100 * err:+.1f}%)"
              + ("" if r in runs else " (held out of the fit)"))
    print(f"# worst in the fit {100 * worst:.1f}%")


if __name__ == "__main__":
    main()
