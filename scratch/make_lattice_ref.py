"""Plan the 7x7 bond-16 square lattice and compute its float64 reference.

The lattice (``lattice_equation([7, 7], d_min=16)``, no output) is the
classical partition function of a 7x7 grid, or the double-layer norm
network of a 7x7 PEPS of bond dimension 4. With positive entries its
value (~1e86) leaves float32's range, so only an exponent-stripped
contraction can give it in float32: the workload of the executor's
``strip_exponent`` path and its fused matmul+|max| steps.

Writes ``plans/lattice7x7_d16_s16.json``: the tree, planned with the
repo's own planner (random greedy over 128 trials, subtree
reconfiguration, then slicing to intermediates of at most 2^28
elements), and under its ``"reference"`` key the instance recipe and
the float64 value, contracted by the JAX package on the CPU with
``strip_exponent=True``, as mantissa, log10 exponent and
``log10|value|``. The value lives in the plan file, not in a sidecar,
because every ``plans/*.json`` other than a ``.refamp.json`` must parse
as a plan (``tests/test_plans.py``).

The inputs are ``rng.uniform(size=shape)`` for every input in order,
from one ``np.random.default_rng(7)``, in float64.

Usage: python scratch/make_lattice_ref.py   (~11 minutes on 8 cores, ~5 GB)
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

NAME = "lattice7x7_d16_s16"
DIMS = (7, 7)
BOND = 16
ARRAY_SEED = 7
PLAN_TRIALS = 128
PLAN_SEED = 0
TARGET_SIZE = 2**28


def main():
    from cotengra_tpu import (
        ContractionTree,
        lattice_equation,
        optimize_random_greedy_track_flops,
    )
    from cotengra_tpu.utils.io import save_tree

    inputs, output, shapes, size_dict = lattice_equation(
        list(DIMS), d_min=BOND
    )
    t0 = time.time()
    path, _ = optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=PLAN_TRIALS, seed=PLAN_SEED
    )
    tree = ContractionTree.from_path(inputs, output, size_dict, path=path)
    tree.subtree_reconfigure_(subtree_size=8)
    tree.slice_and_reconfigure_(TARGET_SIZE)
    print(
        f"plan: {tree.multiplicity} slices, log2 max size "
        f"{tree.max_size(log=2):.1f}, log10 flops "
        f"{tree.total_flops(log=10):.2f} ({time.time() - t0:.1f}s)"
    )
    plan_file = os.path.join(ROOT, "plans", f"{NAME}.json")
    save_tree(plan_file, tree)
    print(f"wrote {plan_file} (no reference yet)")

    rng = np.random.default_rng(ARRAY_SEED)
    arrays = [rng.uniform(size=s) for s in shapes]
    t0 = time.time()
    m, e = tree.contract(arrays, strip_exponent=True)
    m, e = float(np.asarray(m)), float(np.asarray(e))
    seconds = time.time() - t0
    log10 = float(np.log10(abs(m)) + e)
    print(f"value: {m!r} * 10^{e!r}, log10 {log10!r} ({seconds:.1f}s)")

    reference = {
        "instance": {
            "equation": "lattice_equation",
            "dims": list(DIMS),
            "d_min": BOND,
            "arrays": "np.random.default_rng(seed).uniform(size=s)"
            " for s in shapes, one generator, in input order",
            "seed": ARRAY_SEED,
        },
        "dtype": "float64",
        "slices": tree.multiplicity,
        "mantissa": m,
        "exponent": e,
        "log10": log10,
    }
    save_tree(plan_file, tree, reference=reference)
    print(f"wrote {plan_file} with its reference value")


if __name__ == "__main__":
    main()
