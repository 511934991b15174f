"""Plan Sycamore-53 m=10 and the 7x7 lattice with ``chip_smoke.py``'s
seeded searches (phases 17-20: the hyper methods' seeded counterparts,
the slice finder at temperature 0) on the host, twice each, and print
each tree's hash, slices and log10 flops: repeated runs give the same
trees. No card needed.

    python scratch/seeded_plans.py [repeats]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
m10, _, _ = cs._load_instance(cs.T27)
lattice, _, _ = cs._load_lattice()
print(f"m10 log10 flops limit "
      f"{m10.total_flops(log=10) + cs.HYPER_FLOPS_SLACK:.3f}", flush=True)
for rep in range(reps):
    for methods in (cs.HYPER_LABELS, None):
        for name, tree, target in (
            ("m10", m10, cs.HYPER_M10_TARGET),
            ("7x7", lattice, cs.HYPER_LATTICE_TARGET),
        ):
            planned, secs, _, note = cs._hyper_plan(tree, target, methods)
            print(f"{name} repeat {rep}: {secs:.1f}s {note}: "
                  f"{cs._plan_stats(planned)}", flush=True)
