"""Plan ``chip_smoke.py``'s phases 27-30 on the host, without a card:
the mixed 7x7 lattice's kernel steps (those whose operands both stay
real with input 0 complex), the JAX package's example planned on m10
(its ``describe("full")``, which phase 29 holds to
``chip_smoke.EXAMPLE_DESCRIBE``; chain passes per slice) and the
``HyperMultiOptimizer`` plan of phase 30 (its flops, largest
intermediate, ``exact_multi_stats`` and chain passes), each twice: the
same trees every run.

    python scratch/example_multi_plans.py [repeats]
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
lattice, _, _ = cs._load_lattice()
mixed = len(cs._kernel_step_ids(lattice, {cs.MIXED_INPUT}))
real = len(cs._kernel_step_ids(lattice))
print(f"mixed 7x7: {mixed} real kernel steps per slice x "
      f"{lattice.multiplicity} = {mixed * lattice.multiplicity} launches "
      f"(every input real: {real * lattice.multiplicity})", flush=True)
m10, _, _ = cs._load_instance(cs.T27)
for rep in range(reps):
    tree, secs = cs._example_plan(m10.inputs, m10.output, m10.size_dict)
    print(f"example m10 repeat {rep}: {secs:.1f}s tree {cs._tree_hash(tree)} "
          f"{tree.describe('full')!r} (expected "
          f"{tree.describe('full') == cs.EXAMPLE_DESCRIBE}); chain passes "
          f"per slice {cs._chain_passes(tree)} x {tree.multiplicity}",
          flush=True)
    multi, secs = cs._multi_plan(m10)
    t0 = time.perf_counter()
    stats = multi.exact_multi_stats(cs._multi_configs(m10))
    sliced = cs._multi_sliced(multi)
    print(f"multi m10 repeat {rep}: {secs:.1f}s tree {cs._tree_hash(multi)} "
          f"total_flops {multi.total_flops():.6e} log2 max "
          f"{multi.max_size(log=2):.2f} exact_multi_stats {stats} "
          f"({time.perf_counter() - t0:.1f}s); sliced: "
          f"{sliced.describe('full')} chain passes per slice "
          f"{cs._chain_passes(sliced)} x {sliced.multiplicity}", flush=True)
