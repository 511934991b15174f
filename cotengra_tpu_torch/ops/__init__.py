"""Execution of planned contraction trees on torch tensors."""

from .executor import (
    benchmark_tree,
    contract_core,
    contract_slice,
    contract_slices,
    contract_tree,
    gather_slices,
    gen_output_chunks,
    make_contractor,
    make_full_contractor,
    slice_arrays,
)
from .grouped import make_grouped_contractor

__all__ = [
    "benchmark_tree",
    "contract_core",
    "contract_slice",
    "contract_slices",
    "contract_tree",
    "gather_slices",
    "gen_output_chunks",
    "make_contractor",
    "make_full_contractor",
    "make_grouped_contractor",
    "slice_arrays",
]
