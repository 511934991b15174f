#!/usr/bin/env python3
"""How many ``bmm_absmax_kernel`` launches ``torch.profiler`` reports for
one call of the stripped 7x7 lattice captured as one CUDA graph
(``make_full_contractor(..., autojit=True, implementation="pallas")``;
the plan launches 464), over repeated profiled calls, with CPU and CUDA
activities and with CUDA alone; and the eager call's count beside them.
Where a call's kernels by name differ from the first call's, it prints
the difference, and every call's count of device events. Each window
ends in ``PAD`` spin kernels after the call, counted apart: were the
records lost at a window's end, they would be the pad's. On one card:

    python scratch/profiler_counts.py [calls]
"""

import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PAD = 512


def _count(call, activities):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for _ in range(PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    busy, names = 0.0, collections.Counter()
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if "spin_kernel" in e.name:
            names["pad"] += 1
            continue
        busy += e.time_range.elapsed_us() / 1e3
        names[e.name] += 1
    n = sum(c for k, c in names.items() if "bmm_absmax_kernel" in k)
    return n, busy, wall, names


def main():
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import resolve_device

    calls = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = resolve_device("cuda")
    cs.phase_device()
    cs.phase_build()
    tree, arrays, _ = cs._load_lattice()
    tensors = ctt.to_tensors(arrays, dev, torch.float32)
    kw = dict(strip_exponent=True, implementation="pallas")
    fn = ctt.make_full_contractor(tree, dev, autojit=True, **kw)
    eager = ctt.make_full_contractor(tree, dev, **kw)
    fn(*tensors)
    eager(*tensors)
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cuda = [ProfilerActivity.CUDA]
    for label, call in (("captured", lambda: fn(*tensors)),
                        ("eager", lambda: eager(*tensors))):
        for name, acts in (("cpu+cuda", both), ("cuda", cuda)):
            rows = [_count(call, acts) for _ in range(calls)]
            print(f"# {label} {name}: bmm_absmax_kernel launches "
                  f"{[r[0] for r in rows]}; busy ms "
                  f"{[round(r[1], 1) for r in rows]}; wall ms "
                  f"{[round(r[2], 1) for r in rows]}; device events "
                  f"{[sum(r[3].values()) - r[3]['pad'] for r in rows]}; "
                  f"pad events {[r[3]['pad'] for r in rows]}", flush=True)
            first = rows[0][3]
            for k, r in enumerate(rows[1:], 1):
                if r[3] != first:
                    more, fewer = r[3] - first, first - r[3]
                    print(f"#   call {k}: more {dict(more)} fewer "
                          f"{dict(fewer)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
