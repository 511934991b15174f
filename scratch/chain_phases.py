#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s gate-chain phases alone, after the device line
and the build, on one card:

    python scratch/chain_phases.py [3] [10] [31]

3: every m=10 t27 chain and the two-pass synthetic chain, kernel against
plain; 10: every m=20 t28 chain likewise (the per-chain table: kernel
ms, bound, % of it); 31: the slice leg (t27 chains at 4 slices, the
largest m20 chain at 16). With no argument, all three. Run from any
checkout (the script reads the ``chip_smoke.py`` beside its own
``scratch/``), so that two checkouts can be timed in turns in one call.
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

    phases = sys.argv[1:] or ["3", "10", "31"]
    dev = resolve_device("cuda")
    print(f"# checkout {ROOT}", flush=True)
    cs.phase_device()
    cs.phase_build()
    for phase in phases:
        {"3": cs.phase_chains, "10": cs.phase_chains_m20,
         "31": cs.phase_vmap_chains}[phase](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
