#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases of the opt-in gate engines alone (37-41:
the window engine on m10-t27 and m20-t28, fused kron chains, the layout
lookahead, and the cost model on their runs), after the device line and
the build, on one card:

    python scratch/engine_phases.py [--profile]

``--profile`` then profiles one warm pass of t27 under ``"vmap"`` with
``gate_mode="window"`` (the window steps and operator builds as ranges
of their own), as ``chip_smoke.py --profile`` does last.
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
    _, window_s = cs.phase_window_t27(dev)
    _, fused_s = cs.phase_fused_t27(dev)
    cs.phase_lookahead_t27(dev)
    cs.phase_window_m20(dev)
    cs.phase_engine_model(window_s, fused_s)
    if sys.argv[1:] == ["--profile"]:
        cs.phase_profile(cs.T27, dev, slice_batch=4, mode="vmap",
                         gate_mode="window")
    return 0


if __name__ == "__main__":
    sys.exit(main())
