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
    make_staged_contractor,
    slice_arrays,
)
from .grouped import make_grouped_contractor, make_grouped_staged_contractor
from .lowering import ContractionIR, extract_contractions
from .pairwise import (
    apply_pairwise,
    apply_single,
    einsum as pairwise_einsum,
    tensordot,
)

__all__ = [
    "ContractionIR",
    "apply_pairwise",
    "apply_single",
    "benchmark_tree",
    "contract_core",
    "contract_slice",
    "contract_slices",
    "contract_tree",
    "extract_contractions",
    "gather_slices",
    "gen_output_chunks",
    "make_contractor",
    "make_full_contractor",
    "make_grouped_contractor",
    "make_grouped_staged_contractor",
    "make_staged_contractor",
    "pairwise_einsum",
    "slice_arrays",
    "tensordot",
]
