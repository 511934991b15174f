#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s eager slice-batch phases 32-34 (m10-t27 and
m20-t28 under "vmap" against "scan", the 512 small slices in calls of
16) of a checkout, after the device line and the build, on one card.
To hold two checkouts against each other, run it for each in turns in
one call (parent, change, change, parent):

    python scratch/eager_phases.py [checkout]   # default: this one
"""

import sys
from pathlib import Path

ROOT = (Path(sys.argv[1]) if len(sys.argv) > 1
        else Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    from cotengra_tpu_torch import resolve_device

    print(f"# checkout {ROOT}", flush=True)
    dev = resolve_device("cuda")
    cs.phase_device()
    cs.phase_build()
    cs.phase_vmap_t27(dev)
    cs.phase_vmap_m20(dev)
    cs.phase_small_slices(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
