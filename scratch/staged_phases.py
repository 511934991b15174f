#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases of the staged contractor alone (43-46:
m10-t27 and m20-t28 through captured CUDA graphs against the eager
contractor, the stripped 7x7 lattice under ``autojit``, stages against
one graph), after the device line and the build, on one card:

    python scratch/staged_phases.py
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
    cs.phase_staged_t27(dev)
    cs.phase_staged_m20(dev)
    cs.phase_staged_lattice(dev)
    cs.phase_staged_one_graph(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
