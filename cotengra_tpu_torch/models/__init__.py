"""Instance builders (counterparts of ``cotengra_tpu/models``)."""

from .circuits import rand_circuit_tn
from .instances import (
    Contraction,
    lattice_equation,
    make_arrays_from_eq,
    make_arrays_from_inputs,
    make_rand_size_dict_from_inputs,
    make_shapes_from_inputs,
    networkx_graph_to_equation,
    perverse_equation,
    rand_equation,
    rand_tree,
    randreg_equation,
    tree_equation,
)

__all__ = [
    "Contraction",
    "lattice_equation",
    "make_arrays_from_eq",
    "make_arrays_from_inputs",
    "make_rand_size_dict_from_inputs",
    "make_shapes_from_inputs",
    "networkx_graph_to_equation",
    "perverse_equation",
    "rand_circuit_tn",
    "rand_equation",
    "rand_tree",
    "randreg_equation",
    "tree_equation",
]
