#!/usr/bin/env python3
"""Warm seconds of the batched grouped call in ``"scan"`` mode on the
card, for the package found at a given checkout root:

    python scratch/compare_scan.py <checkout root> [label]

m20-t28 slices 0..15 in one call and m10-t27's 4 slices in one call,
best of 5 passes each (each ending in a host pull), with the device's
busy time of one pass from ``torch.profiler``. Run it for two checkouts
in turns (A, B, B, A) in one call on the card to compare them.
"""

import sys
import time
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
# chip_smoke.py's loaders, behind the checkout under test
sys.path.append(str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import cotengra_tpu_torch as ctt  # noqa: E402
import chip_smoke as cs  # noqa: E402


def main():
    label = sys.argv[2] if len(sys.argv) > 2 else str(root)
    assert Path(ctt.__file__).resolve().is_relative_to(root), ctt.__file__
    dev = ctt.resolve_device("cuda")
    for plan, n in ((cs.M20, 16), (cs.T27, 4)):
        tree, arrays, _ = cs._load_instance(plan)
        planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
        kw = {"slice_batch": n}
        names = ctt.make_grouped_contractor.__code__.co_varnames
        if "slice_batch_mode" in names:  # the parent had "scan" only
            kw["slice_batch_mode"] = "scan"
        fn = ctt.make_grouped_contractor(tree, dev, torch.float32, **kw)

        def one():
            out = fn(planes, range(n)).sum(0)
            return complex(out[0].item(), out[1].item())

        one()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            times.append(time.perf_counter() - t0)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
        print(f"# {label} {plan} scan x{n}: warm "
              f"{' '.join(f'{t:.4f}' for t in times)} (best {min(times):.4f})"
              f" busy {busy:.1f} ms", flush=True)
        del planes, fn
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
