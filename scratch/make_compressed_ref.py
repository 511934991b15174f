"""Compute the reference value of the compressed 16x16 bond-4 lattice.

``chip_smoke.py`` plans ``lattice_equation([16, 16], d_min=4)`` with
``cotengra_tpu_torch``'s own ``greedy_compressed_ssa(..., chi=32)``,
builds a ``ContractionTreeCompressed`` from the path and contracts it
on the card with ``contract_compressed(arrays, chi=32,
strip_exponent=True)``, in float64 and with the inputs cast to float32.
It holds the path's hash and the value's log10 to the constants this
script prints (``COMPRESSED_*`` there).

The inputs are ``1 + 0.05 * rng.normal(size=shape)`` for every input in
order, from one ``np.random.default_rng(0)``, in float64, as
``tests/test_compressed.py`` and ``examples/ex_compressed_peps.py`` make
them. This script plans with the JAX package's ``greedy_compressed_ssa``
(temperature 0: deterministic) and contracts with its
``contract_compressed`` on the CPU with x64 on. The reference sums the
stripped exponent in float32 (``cotengra_tpu/ops/compressed.py``), so
the log10 printed carries that sum's rounding.

Usage: python scratch/make_compressed_ref.py   (JAX package; about two
minutes on the CPU, a few GB)
"""

import hashlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

DIMS = (16, 16)
BOND = 4
CHI = 32
ARRAY_SEED = 0


def path_hash(ssa_path):
    """sha256 of the SSA path's ``repr`` as a tuple of int pairs."""
    text = repr(tuple(tuple(int(i) for i in step) for step in ssa_path))
    return hashlib.sha256(text.encode()).hexdigest()


def main():
    from cotengra_tpu import lattice_equation
    from cotengra_tpu.pathfinders.compressed import greedy_compressed_ssa
    from cotengra_tpu.tree_compressed import ContractionTreeCompressed

    inputs, output, shapes, size_dict = lattice_equation(
        list(DIMS), d_min=BOND
    )
    t0 = time.time()
    ssa_path = greedy_compressed_ssa(inputs, output, size_dict, chi=CHI)
    plan_s = time.time() - t0
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, ssa_path=ssa_path
    )
    stats = tree.compressed_contract_stats(chi=CHI, accel=False)
    print(
        f"plan: {plan_s:.1f}s, ssa path hash {path_hash(ssa_path)}, "
        f"log2 max {np.log2(stats.max_size)!r}, log2 peak "
        f"{np.log2(stats.peak_size)!r}, log10 flops "
        f"{np.log10(stats.flops)!r}"
    )
    rng = np.random.default_rng(ARRAY_SEED)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    t0 = time.time()
    m, e = tree.contract_compressed(arrays, chi=CHI, strip_exponent=True)
    m, e = float(np.asarray(m)), float(np.asarray(e))
    print(
        f"mantissa {m!r} exponent {e!r} log10 {np.log10(abs(m)) + e!r} "
        f"({time.time() - t0:.1f}s)"
    )


if __name__ == "__main__":
    main()
