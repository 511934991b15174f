#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases of the "vmap" slice-batch mode and the
cost model alone (31-36, after the device line and the build), on one
card:

    python scratch/vmap_phases.py

Prints what those phases print, including the ``{"calibration": ...}``
JSON line that ``scratch/sim_calibrate_gpu.py`` fits
``ops/simulate.py``'s ``H100_CONSTANTS`` to.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    from cotengra_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    cs.phase_device()
    cs.phase_build()
    cs.phase_vmap_chains(dev)
    _, t27_modes = cs.phase_vmap_t27(dev)
    _, m20_batch, m20_modes = cs.phase_vmap_m20(dev)
    small_tree, _, small_modes = cs.phase_small_slices(dev)
    cs.phase_calibration(
        dev, cs.vmap_measured(t27_modes, m20_batch, m20_modes, small_tree,
                              small_modes),
    )
    cs.phase_gpu_planned(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
