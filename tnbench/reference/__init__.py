"""The plain reference: a committed plan contracted pairwise in plain
PyTorch, node by node in the plan's order, with no kernel, cache or
batching of the program. It imports neither JAX nor the program.
"""

from .contract import contract_slices, slice_values, tf32_round

__all__ = ["contract_slices", "slice_values", "tf32_round"]
