#!/usr/bin/env python3
"""How much of a compressed call's host time its ``compressed.*`` spans
cover, on the card:

    python scratch/compressed_spans.py [calls]

Plans the 16x16 bond-4 lattice at chi=32 and draws its float64 inputs
as ``chip_smoke.py`` phase 16 does, puts them on the card, warms one
call, then runs ``calls`` calls under ``tracing.record()``, each pulled
to the host, and prints per call: its wall time and the ``entry`` span
(ms), the share of the entry under the ``compressed.step`` spans, the
self ms of the entry, the steps, the neighbour passes and the
truncations, the span counts and the truncations that ``COUNTS``
gained.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NAMES = ("compressed.step", "compressed.neighbours", "compressed.truncate")


def main():
    import torch

    import chip_smoke
    from cotengra_tpu_torch import tracing
    from cotengra_tpu_torch.ops import compressed
    from cotengra_tpu_torch.pathfinders.compressed import (
        greedy_compressed_ssa,
    )
    from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda")
    chi = chip_smoke.COMPRESSED_CHI
    inputs, output, size_dict, arrays = chip_smoke._compressed_inputs()
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict,
        ssa_path=greedy_compressed_ssa(inputs, output, size_dict, chi=chi),
    )
    tensors = [torch.as_tensor(a, dtype=torch.float64, device=dev)
               for a in arrays]

    def call():
        m, e = tree.contract_compressed(
            tensors, chi=chi, strip_exponent=True, device=dev
        )
        return m.item(), e.item()

    call()
    for _ in range(n):
        before = compressed.COUNTS["truncations"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.record():
            m, e = call()
        wall = time.perf_counter() - t0
        recs = tracing.records()
        own = tracing.self_ns(recs)
        entry = next(r for r in recs if r.name == "entry")
        under = sum(r.end - r.start for r in recs
                    if r.name == "compressed.step")
        print(json.dumps({
            "wall_ms": wall * 1e3,
            "entry_ms": (entry.end - entry.start) * 1e-6,
            "steps_cover": under / (entry.end - entry.start),
            "self_ms": {
                name: sum(own[r.index] for r in recs if r.name == name) * 1e-6
                for name in ("entry", *NAMES)
            },
            "spans": {name: sum(r.name == name for r in recs)
                      for name in NAMES},
            "truncations": compressed.COUNTS["truncations"] - before,
            "log10": float(torch.tensor(abs(m)).log10()) + e,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
