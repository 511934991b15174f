"""Host-side pools for the planner's search (counterpart of
``cotengra_tpu/parallel``; its device mesh, ``mesh.py``, is not ported
yet)."""

from .pools import (
    get_num_workers,
    get_pool_size,
    parse_parallel_arg,
    submit,
)

__all__ = [
    "get_num_workers",
    "get_pool_size",
    "parse_parallel_arg",
    "submit",
]
