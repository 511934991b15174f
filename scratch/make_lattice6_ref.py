"""Compute the float64 reference value of the 6x6 bond-16 square lattice.

``chip_smoke.py`` contracts ``lattice_equation([6, 6], d_min=16)`` through
``cotengra_tpu_torch.einsum`` with the default ``optimize="auto"`` (the
port plans the path itself), exponent-stripped in float32, and holds
its log10 to the value this script prints (``LATTICE6_LOG10`` there).

The inputs are ``rng.uniform(size=shape)`` for every input in order,
from one ``np.random.default_rng(7)``, in float64 (the chip run casts
the same draws to float32), as for ``plans/lattice7x7_d16_s16.json``.
The value does not depend on the path: this script plans with the JAX
package's random-greedy (32 trials, seed 0) and contracts with its
``strip_exponent=True`` on the CPU in float64.

Usage: python scratch/make_lattice6_ref.py   (JAX package; about a
minute on one core, under 1 GB)
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

DIMS = (6, 6)
BOND = 16
ARRAY_SEED = 7


def main():
    from cotengra_tpu import (
        ContractionTree,
        lattice_equation,
        optimize_random_greedy_track_flops,
    )

    inputs, output, shapes, size_dict = lattice_equation(
        list(DIMS), d_min=BOND
    )
    path, _ = optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=32, seed=0
    )
    tree = ContractionTree.from_path(inputs, output, size_dict, path=path)
    print(
        f"plan: log2 max size {tree.max_size(log=2):.1f}, log2 peak "
        f"{tree.peak_size(log=2):.1f}, log10 flops "
        f"{tree.total_flops(log=10):.2f}"
    )
    rng = np.random.default_rng(ARRAY_SEED)
    arrays = [rng.uniform(size=s) for s in shapes]
    t0 = time.time()
    m, e = tree.contract(arrays, strip_exponent=True)
    m, e = float(np.asarray(m)), float(np.asarray(e))
    print(
        f"mantissa {m!r} exponent {e!r} log10 {np.log10(abs(m)) + e!r} "
        f"({time.time() - t0:.1f}s)"
    )


if __name__ == "__main__":
    main()
