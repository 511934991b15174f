"""The port's instance builders, instance and tree files, symbol map and
executor-default setters against the JAX package's: equal outputs for
the same seeds (arrays bitwise), files that either package writes load
in the other with the hash check on, and every top-level name of the
JAX package present in the port but those still queued."""

import ast
import io
from pathlib import Path

import pytest
import torch

import cotengra_tpu as ctg
from cotengra_tpu import config as ref_config

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch import config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

BUILDERS = [
    ("tree_equation", (12,), {"n_outer": 2}),
    ("tree_equation", (30,), {"d_min": 2, "d_max": 5}),
    ("randreg_equation", (10, 3), {}),
    ("randreg_equation", (16, 4), {"d_min": 3, "d_max": 4}),
    ("perverse_equation", (8,), {}),
    ("perverse_equation", (12,), {"n_inputs": 9, "d_max": 4}),
    ("rand_equation", (14, 3), {"n_out": 2, "n_hyper_in": 1,
                                "n_hyper_out": 1}),
    ("lattice_equation", ((3, 4),), {"cyclic": True, "d_max": 4}),
]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize(
    "name,args,kwargs", BUILDERS, ids=lambda x: str(x)[:24]
)
def test_equation_builders_equal_the_reference(name, args, kwargs, seed):
    got = getattr(ctt, name)(*args, seed=seed, **kwargs)
    exp = getattr(ctg, name)(*args, seed=seed, **kwargs)
    assert got == exp  # inputs, output, shapes and size_dict, in order
    assert list(got.size_dict) == list(exp.size_dict)


@pytest.mark.parametrize("seed", [0, 3])
def test_networkx_graph_to_equation_equals_the_reference(seed):
    nx = pytest.importorskip("networkx")
    for G in (nx.petersen_graph(), nx.grid_2d_graph(3, 4),
              nx.random_regular_graph(3, 12, seed=seed)):
        got = ctt.networkx_graph_to_equation(G, d_max=4, seed=seed)
        assert got == ctg.networkx_graph_to_equation(G, d_max=4, seed=seed)


@pytest.mark.parametrize("dtype", ["float64", "float32", "complex128"])
@pytest.mark.parametrize("seed", [None, 0, 5])
def test_example_arrays_equal_the_reference(dtype, seed):
    inputs, _, _, _ = ctg.rand_equation(9, 3, n_out=1, seed=2)
    sizes = ctt.make_rand_size_dict_from_inputs(inputs, d_max=4, seed=4)
    assert sizes == ctg.make_rand_size_dict_from_inputs(
        inputs, d_max=4, seed=4
    )
    assert ctt.make_shapes_from_inputs(inputs, sizes) == (
        ctg.make_shapes_from_inputs(inputs, sizes)
    )
    if seed is None:
        return  # unseeded draws agree in shape only
    got = ctt.make_arrays_from_inputs(inputs, sizes, seed=seed, dtype=dtype)
    exp = ctg.make_arrays_from_inputs(inputs, sizes, seed=seed, dtype=dtype)
    for g, e in zip(got, exp, strict=True):
        assert g.dtype == e.dtype and g.tobytes() == e.tobytes()
    eq = ctg.utils.inds_to_eq(inputs)
    got = ctt.make_arrays_from_eq(eq, d_max=4, seed=seed, dtype=dtype)
    exp = ctg.make_arrays_from_eq(eq, d_max=4, seed=seed, dtype=dtype)
    for g, e in zip(got, exp, strict=True):
        assert g.dtype == e.dtype and g.tobytes() == e.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_tree_equals_the_reference(seed):
    got = ctt.rand_tree(12, 3, n_out=2, seed=seed)
    exp = ctg.rand_tree(12, 3, n_out=2, seed=seed)
    assert isinstance(got, ctt.ContractionTree)
    assert (got.inputs, got.output, got.size_dict) == (
        exp.inputs, exp.output, exp.size_dict
    )
    assert got.children == exp.children


def test_get_symbol_map_equals_the_reference():
    inputs = [("x", 3), (3, ("t", 1), "y"), (), ("y", "x", 7)]
    assert ctt.get_symbol_map(inputs) == ctg.get_symbol_map(inputs)
    wide = [tuple(range(k, k + 60)) for k in range(0, 300, 50)]
    assert ctt.get_symbol_map(wide) == ctg.get_symbol_map(wide)


def test_default_implementation_setters_mirror_the_reference():
    assert ctt.get_default_implementation() is None
    try:
        ctt.set_default_implementation("pallas")
        assert ctt.get_default_implementation() == "pallas"
        assert config.get_default("implementation") == "pallas"
        # the JAX package's setting is its own
        assert ref_config.get_default_implementation() is None
    finally:
        ctt.set_default_implementation(None)
    assert ctt.get_default_implementation() is None


def _sliced_pair(seed):
    """A reference tree, sliced, and the same tree built by the port."""
    inputs, output, _, size_dict = ctg.rand_equation(
        12, 3, n_out=2, seed=seed
    )
    ref = ctg.array_contract_tree(inputs, output, size_dict=size_dict,
                                  optimize="greedy")
    ref.slice_(target_slices=6)
    port = ctt.ContractionTree.from_path(
        ref.inputs, ref.output, ref.size_dict, ssa_path=ref.get_ssa_path()
    )
    for ix in ref.sliced_inds:
        port.remove_ind_(ix)
    return ref, port


def _same_tree(a, b):
    assert a.children == b.children
    assert list(a.sliced_inds) == list(b.sliced_inds)
    assert a.multiplicity == b.multiplicity


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("to_file", [False, True])
def test_tree_files_load_in_either_package(seed, to_file, tmp_path):
    ref, port = _sliced_pair(seed)
    instance = (ref.inputs, ref.output, ref.size_dict)
    for save, load, tree in ((ctt.save_tree, ctg.load_tree, port),
                             (ctg.save_tree, ctt.load_tree, ref)):
        if to_file:
            target = str(tmp_path / f"{save.__module__}.json")
            save(target, tree, note="meta")
            loaded = load(target, *instance, check_hash=True)
        else:
            buf = io.StringIO()
            save(buf, tree, note="meta")
            buf.seek(0)
            loaded = load(buf, *instance, check_hash=True)
        _same_tree(loaded, tree)
    # the reference's file, loaded and saved again by the port: the same
    # bytes
    a, b = io.StringIO(), io.StringIO()
    ctg.save_tree(b, ref)
    b.seek(0)
    ctt.save_tree(a, ctt.load_tree(b, *instance))
    assert a.getvalue() == b.getvalue()
    # the hash check holds for a tree from the other package too
    other = ctg.rand_equation(12, 3, n_out=2, seed=seed + 1)
    a.seek(0)
    with pytest.raises(ValueError, match="different instance"):
        ctg.load_tree(a, other.inputs, other.output, other.size_dict)


@pytest.mark.parametrize("meta", [{}, {"note": "x", "flops": 12}])
def test_instance_files_load_in_either_package(meta, tmp_path):
    inputs, output, _, size_dict = ctg.rand_equation(10, 3, n_out=2, seed=1)
    for save, load in ((ctt.save_instance, ctg.load_instance),
                       (ctg.save_instance, ctt.load_instance)):
        target = str(tmp_path / "instance.json")
        save(target, inputs, output, size_dict, **meta)
        got = load(target)
        assert got == (
            [tuple(t) for t in inputs], tuple(output), size_dict,
            *([meta] if meta else []),
        )
        buf = io.StringIO()
        save(buf, inputs, output, size_dict, **meta)
        buf.seek(0)
        assert load(buf) == got
    a, b = io.StringIO(), io.StringIO()
    ctt.save_instance(a, inputs, output, size_dict, **meta)
    ctg.save_instance(b, inputs, output, size_dict, **meta)
    assert a.getvalue() == b.getvalue()


# -- top-level names ---------------------------------------------------------

# Top-level names of ``cotengra_tpu`` the port does not have yet, each
# with the ROADMAP item that queues it. The list shrinks as modules are
# ported.
QUEUED = {
    # A7: HyperMultiOptimizer with tree_multi.py
    "ContractionTreeMulti": "A7",
    "HyperMultiOptimizer": "A7",
    # A7: the external, kahypar and igraph path finders
    "FlowCutterOptimizer": "A7",
    "QuickBBOptimizer": "A7",
    "optimize_flowcutter": "A7",
    "optimize_quickbb": "A7",
    "register_external_presets": "A7",
    "register_kahypar_hyper_methods": "A7",
    "register_igraph_hyper_methods": "A7",
    "path_kahypar": "A7",
    "path_igraph": "A7",
    # A7: oe.py (opt_einsum preset registration)
    "OEPathOptimizer": "A7",
    "register_opt_einsum_presets": "A7",
    # not queued (ROADMAP A, last paragraph): plot.py draws on the host
    "plot_contractions": "A, plot.py",
    "plot_contractions_alt": "A, plot.py",
    "plot_hypergraph": "A, plot.py",
    "plot_scatter": "A, plot.py",
    "plot_scatter_alt": "A, plot.py",
    "plot_slicings": "A, plot.py",
    "plot_slicings_alt": "A, plot.py",
    "plot_tree": "A, plot.py",
    "plot_tree_circuit": "A, plot.py",
    "plot_tree_ring": "A, plot.py",
    "plot_tree_span": "A, plot.py",
    "plot_tree_tent": "A, plot.py",
    "plot_trials": "A, plot.py",
    "plot_trials_alt": "A, plot.py",
    "tree_to_df": "A, plot.py",
    "tree_to_networkx": "A, plot.py",
}


def _reference_top_level_names():
    """The public names ``cotengra_tpu/__init__.py`` binds (imports,
    assignments, definitions), read from its source so that the answer
    does not depend on which submodules a test process imported."""
    tree = ast.parse((ROOT / "cotengra_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_")}


def test_every_reference_top_level_name_is_ported_or_queued():
    names = _reference_top_level_names()
    assert {"einsum", "save_tree", "plot_tree", "HyperMultiOptimizer"} <= names
    missing = {n for n in names if not hasattr(ctt, n)}
    assert missing == set(QUEUED), (
        f"not in the port and not queued: {sorted(missing - set(QUEUED))}; "
        f"queued but ported: {sorted(set(QUEUED) - missing)}"
    )
    for name in set(ctg.__all__) - set(QUEUED):
        assert name in ctt.__all__ or hasattr(ctt, name), name


def test_mesh_names_where_the_reference_exports_them():
    from cotengra_tpu import parallel as ref_parallel

    from cotengra_tpu_torch import parallel

    mesh_names = {"broadcast_tree", "contract_sharded", "get_default_mesh",
                  "get_global_mesh", "make_sharded_contractor",
                  "maybe_init_distributed"}
    assert mesh_names <= set(ref_parallel.__all__)
    assert mesh_names <= set(parallel.__all__)
