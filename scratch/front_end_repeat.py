"""Run ``chip_smoke.py``'s t27 front-end phase (``array_contract`` with
the loaded tree, then its warm time against ``make_full_contractor``'s
in turns, held to 1.1x) several times in one process on the card, and
count how often the timing check fails.

    python scratch/front_end_repeat.py <checkout> <repeats>

``<checkout>`` is the root of a checkout (this one, or an older commit
unpacked with ``git archive``), so that two commits can be compared on
one card in turns.
"""
import os
import sys

root = os.path.abspath(sys.argv[1])
reps = int(sys.argv[2])
os.chdir(root)
sys.path.insert(0, root)
import chip_smoke as cs  # noqa: E402
from cotengra_tpu_torch import resolve_device  # noqa: E402

dev = resolve_device("cuda")
cs.phase_build()
fails = 0
for r in range(reps):
    try:
        cs.phase_front_t27(dev)
    except AssertionError as exc:
        fails += 1
        print("FAILED:", exc, flush=True)
print(f"PROBE {root} fails {fails} of {reps}", flush=True)
