"""Host pools for the planner's search and the multi-GPU slice sums
(counterpart of ``cotengra_tpu/parallel``)."""

from .mesh import (
    Mesh,
    broadcast_tree,
    contract_sharded,
    get_default_mesh,
    get_global_mesh,
    make_sharded_contractor,
    maybe_init_distributed,
)
from .pools import (
    get_num_workers,
    get_pool_size,
    parse_parallel_arg,
    set_parallel_backend,
    should_nest,
    submit,
)

__all__ = [
    "Mesh",
    "broadcast_tree",
    "contract_sharded",
    "get_default_mesh",
    "get_global_mesh",
    "get_num_workers",
    "get_pool_size",
    "make_sharded_contractor",
    "maybe_init_distributed",
    "parse_parallel_arg",
    "set_parallel_backend",
    "should_nest",
    "submit",
]
