"""Execution of planned contraction trees on torch tensors."""

from .executor import contract_slices, contract_tree, slice_arrays
from .grouped import make_grouped_contractor

__all__ = [
    "contract_slices",
    "contract_tree",
    "make_grouped_contractor",
    "slice_arrays",
]
