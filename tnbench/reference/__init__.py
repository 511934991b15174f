"""The plain references: a committed plan contracted in plain PyTorch,
with no kernel, cache or batching of the program, one module per
``"kind"`` that a configuration's ``"reference"`` names (see
``tnbench/__init__.py``): ``contract``, the exact walk node by node in
the plan's order, slice by slice (the default), and ``compressed``, the
chi-truncated walk in the plan's surface order. They import neither JAX
nor the program.
"""

from .contract import contract_slices, slice_values, tf32_round

__all__ = ["contract_slices", "slice_values", "tf32_round"]
