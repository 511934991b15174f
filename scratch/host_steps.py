#!/usr/bin/env python3
"""Where the host's time goes in the grouped executor, on one card:

    python scratch/host_steps.py

For m10-t27 (4 slices a call, scan and vmap, and slice by slice) and the
example's m10 tree sliced to 2^22 (its first 64 slices in calls of 16,
scan and vmap): the warm wall of a pass with Python's garbage collector
on, frozen (``gc.freeze()`` after set-up) and off, in turns; then one
pass with every step call timed on the host clock (no synchronisation:
the time the host spends issuing the step, which includes any wait for
a full launch queue), summed by step kind and by branch, with the calls
and the microseconds per call. These are the host terms of
``ops/simulate.py``'s model.
"""

import gc
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import cotengra_tpu_torch as ctt  # noqa: E402
from cotengra_tpu_torch.ops import grouped  # noqa: E402


def _branch(kind, info):
    if kind != "pair":
        return kind
    if info.scatter is not None:
        return "pair-scatter"
    return f"pair-{info.mode}"


def _timed_steps():
    """Wrap the executor's step loop to time each step call."""
    real = grouped._exec_steps_split
    totals = defaultdict(lambda: [0.0, 0])

    def timed(plans, steps, temps, shapes, last_use, strip_exponent=False):
        exponent = None
        for si in steps:
            t0 = time.perf_counter()
            e = real(plans, [si], temps, shapes, last_use, strip_exponent)
            dt = time.perf_counter() - t0
            key = _branch(*plans[si]) + (
                "/batched" if any(
                    t.dim() == 2 for t in temps.values()
                ) and plans[si][0] != "fallback" else "")
            totals[key][0] += dt
            totals[key][1] += 1
            if e is not None:
                exponent = e if exponent is None else exponent + e
        return exponent

    return real, timed, totals


def _passes(label, one, n=3):
    out = {}
    for mode in ("on", "frozen", "off"):
        out[mode] = []
    for _ in range(n):
        for mode in ("on", "frozen", "off"):
            gc.collect()
            if mode == "frozen":
                gc.freeze()
            if mode == "off":
                gc.disable()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            out[mode].append(time.perf_counter() - t0)
            gc.enable()
            gc.unfreeze()
    print(f"# {label}: warm gc on / frozen / off "
          + " / ".join(f"{min(v):.4f}" for v in out.values())
          + f" (best of {n}; gc objects {len(gc.get_objects())})",
          flush=True)


def _attribute(label, one):
    real, timed, totals = _timed_steps()
    grouped._exec_steps_split = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        wall = time.perf_counter() - t0
    finally:
        grouped._exec_steps_split = real
    steps = sum(v[0] for v in totals.values())
    print(f"# {label}: timed pass {wall:.4f} s, in step calls "
          f"{steps:.4f} s", flush=True)
    for key, (s, n) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        print(f"#   {key:22s} {s * 1e3:9.2f} ms {n:6d} calls "
              f"{1e6 * s / n:8.1f} us/call", flush=True)


def main():
    dev = ctt.resolve_device("cuda")
    cs.phase_device()
    cs.phase_build()
    t27, arrays, _ = cs._load_instance(cs.T27)
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    small, _ = cs._small_slices_tree(t27)
    runs = []
    core = ctt.make_grouped_contractor(t27, dev, torch.float32)

    def loop():
        out = ctt.contract_slices(t27, core, planes)
        return out[0].item()

    runs.append(("t27 slice by slice", loop))
    for mode in ("scan", "vmap"):
        fn = ctt.make_grouped_contractor(t27, dev, torch.float32,
                                         slice_batch=4,
                                         slice_batch_mode=mode)
        runs.append((f"t27 {mode} x4", cs._calls_of(fn, planes,
                                                     list(range(4)), 4)))
    for mode in ("scan", "vmap"):
        fn = ctt.make_grouped_contractor(small, dev, torch.float32,
                                         slice_batch=16,
                                         slice_batch_mode=mode)
        runs.append((f"small {mode} 64 in calls of 16",
                     cs._calls_of(fn, planes, list(range(64)), 16)))
    for label, one in runs:
        one()
        _passes(label, one)
        _attribute(label, one)
    return 0


if __name__ == "__main__":
    sys.exit(main())
