"""cotengra_tpu_torch: the PyTorch / CUDA port of cotengra_tpu's
execution.

Planning stays in ``cotengra_tpu``'s host-only modules (``tree``,
``pathfinders``, ``models``, ``utils``); this package runs planned trees
on torch tensors, with its own copies of the host-side lowering and
step planning (it never imports ``cotengra_tpu.ops``, which needs the
reference's accelerator runtime) and a hand-written CUDA kernel for
in-place gate chains.

Entry points take an explicit ``device=``; ``"cuda"`` without a card
raises.
"""

__version__ = "0.1.0"

from ._device import resolve_device
from .convert import to_plane_array, to_plane_tensors
from .ops import (
    contract_slices,
    contract_tree,
    make_grouped_contractor,
    slice_arrays,
)
from .ops.preprocess import absorb_simple_tensors

__all__ = [
    "absorb_simple_tensors",
    "contract_slices",
    "contract_tree",
    "make_grouped_contractor",
    "resolve_device",
    "slice_arrays",
    "to_plane_array",
    "to_plane_tensors",
]
