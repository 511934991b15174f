"""Run ``chip_smoke.py``'s phases 1-12 of the checkout given as the first
argument on the card, then its t27 front-end phase (13-14: warm time
against ``make_full_contractor``'s in turns, held to 1.1x) several
times, and count how often that timing check fails after the earlier
phases, as in a whole smoke run.

    python scratch/front_end_context.py <checkout> <repeats>
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
cs.phase_device()
cs.phase_build()
cs.phase_chains(dev)
cs.phase_main_path(cs.T27, 4, dev)
cs.phase_main_path("sycamore53_m10_t29", 1, dev)
cs.phase_bmm(dev)
cs.phase_lattice(dev)
cs.phase_t27_stripped(dev)
cs.phase_t27_batched(dev)
cs.phase_chains_m20(dev)
cs.phase_m20(dev)
cs.phase_front_lattice(dev)
fails = 0
for r in range(reps):
    try:
        cs.phase_front_t27(dev)
    except AssertionError as exc:
        fails += 1
        print("FAILED:", exc, flush=True)
print(f"CONTEXT {root} fails {fails} of {reps}", flush=True)
