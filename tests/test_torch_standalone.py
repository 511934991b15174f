"""The port stands alone: no module of ``cotengra_tpu_torch`` (nor
``chip_smoke.py``) imports the JAX package or JAX, and the port's own
copies of what it needs - the tree, plan loading, instance builders and
config - match the JAX package's exactly on the committed plans."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import cotengra_tpu as ctg
from cotengra_tpu import config as ref_config
from cotengra_tpu.models.circuits import rand_circuit_tn as ref_rand_circuit
from cotengra_tpu.ops import lowering as ref_lowering
from cotengra_tpu.utils.io import hash_contraction_b as ref_hash
from cotengra_tpu.utils.io import load_tree as ref_load_tree

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch import config
from cotengra_tpu_torch.ops import lowering
from cotengra_tpu_torch.utils.io import hash_contraction_b

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_BLOCKED = ("cotengra_tpu", "jax", "jaxlib")
_SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "cotengra_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]
)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("source", _SOURCES)
def test_no_import_of_the_jax_package_or_jax(source):
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = [
        name for name in _imported_modules(tree)
        if name.split(".")[0] in _BLOCKED
    ]
    assert not bad, f"{source} imports {bad}"


def test_the_scan_sees_every_module():
    assert "chip_smoke.py" in _SOURCES
    for mod in ("tree.py", "config.py", "utils/io.py", "models/circuits.py",
                "ops/executor.py", "ops/bmm_absmax.py", "interface.py",
                "presets.py", "utils/eqs.py", "pathfinders/basic.py",
                "pathfinders/base.py", "pathfinders/edgesort.py",
                "pathfinders/random.py", "hypergraph.py", "scoring.py",
                "tree_compressed.py", "ops/compressed.py",
                "pathfinders/compressed.py", "pathfinders/windowed_opt.py",
                "pathfinders/compressed_bb.py", "ops/native/__init__.py",
                "pathfinders/partition.py", "ops/_build.py"):
        assert f"cotengra_tpu_torch/{mod}" in _SOURCES
    # the native library builds from the port's own copy of its source
    from cotengra_tpu_torch.ops import native

    assert native._SRC == ROOT / "cotengra_tpu_torch/ops/native/kernels.cpp"


# -- instance builders --------------------------------------------------


@pytest.mark.parametrize(
    "n,depth,seed", [(12, 4, 3), (20, 8, 0), (53, 10, 42), (53, 20, 42)]
)
def test_rand_circuit_tn_is_bitwise_the_reference(n, depth, seed):
    got = ctt.rand_circuit_tn(n, depth, seed=seed)
    ref = ref_rand_circuit(n, depth, seed=seed)
    assert got[:4] == ref[:4]
    assert len(got[4]) == len(ref[4])
    for a, b in zip(got[4], ref[4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "dims,kw",
    [
        ([7, 7], dict(d_min=16)),
        ([3, 4], dict(d_min=2, d_max=5, seed=1)),
        ([3, 3, 3], dict(cyclic=True, d_min=2, d_max=3, seed=7)),
        ([4, 2], dict(cyclic=(True, False), d_min=3)),
    ],
)
def test_lattice_equation_is_the_reference(dims, kw):
    got = ctt.lattice_equation(dims, **kw)
    ref = ctg.lattice_equation(dims, **kw)
    assert tuple(got) == tuple(ref)
    assert list(got.size_dict.items()) == list(ref.size_dict.items())


# -- the committed plans through the port's loader ----------------------


def _absorbed(m):
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, m, seed=42)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    return inputs, output, size_dict


def _instance(plan):
    if plan.startswith("lattice"):
        with open(ROOT / "plans" / f"{plan}.json") as f:
            inst = json.load(f)["reference"]["instance"]
        inputs, output, _, size_dict = ctt.lattice_equation(
            inst["dims"], d_min=inst["d_min"]
        )
        return inputs, output, size_dict
    return _absorbed(int(plan.split("_m")[1].split("_")[0]))


_PLANS = [
    "sycamore53_m10_t27",
    "sycamore53_m10_t29",
    "sycamore53_m20_t28",
    "lattice7x7_d16_s16",
]
_TREES = {}


def _sliced(tree):
    return [
        (ix, (si.inner, si.ind, si.size, si.project))
        for ix, si in tree.sliced_inds.items()
    ]


def _trees(plan):
    """(port tree, reference tree) from the same plan file and instance."""
    if plan not in _TREES:
        inputs, output, size_dict = _instance(plan)
        path = str(ROOT / "plans" / f"{plan}.json")
        _TREES[plan] = (
            ctt.load_tree(path, inputs, output, size_dict),
            ref_load_tree(path, inputs, output, size_dict),
        )
    return _TREES[plan]


@pytest.mark.parametrize("plan", _PLANS)
def test_plan_hash_and_structure_match_the_reference(plan):
    got, ref = _trees(plan)
    assert hash_contraction_b(got.inputs, got.output, got.size_dict) == (
        ref_hash(ref.inputs, ref.output, ref.size_dict)
    )
    assert (got.N, got.root, got.inputs, got.output) == (
        ref.N, ref.root, ref.inputs, ref.output
    )
    assert list(got.traverse()) == list(ref.traverse())
    assert got.get_shapes() == ref.get_shapes()
    assert got.total_flops("float32") == ref.total_flops("float32")
    assert got.total_flops("complex64", log=10) == (
        ref.total_flops("complex64", log=10)
    )


@pytest.mark.parametrize("plan", _PLANS)
def test_plan_legs_match_the_reference(plan):
    got, ref = _trees(plan)
    nodes = [*got.children, *(1 << i for i in range(got.N))]
    for node in nodes:
        # same legs, counts and order: the lowering reads them in order
        assert list(got.get_legs(node).items()) == (
            list(ref.get_legs(node).items())
        ), node
        assert got.get_flops(node) == ref.get_flops(node)


@pytest.mark.parametrize("plan", _PLANS)
def test_plan_slicing_matches_the_reference(plan):
    got, ref = _trees(plan)
    assert got.multiplicity == ref.multiplicity
    assert _sliced(got) == _sliced(ref)
    n = got.multiplicity
    for i in sorted({0, 1, n // 3, n // 2, n - 1, 12345 % n}):
        assert got.slice_key(i) == ref.slice_key(i)


@pytest.mark.parametrize("plan", _PLANS)
def test_plan_sizes_match_the_reference(plan):
    got, ref = _trees(plan)
    assert got.max_size() == ref.max_size()
    assert got.max_size(log=2) == ref.max_size(log=2)
    assert got.peak_size() == ref.peak_size()
    assert got.peak_size(log=2) == ref.peak_size(log=2)
    assert (got.nslices, got.nchunks) == (ref.nslices, ref.nchunks)
    for node in [*got.children, *(1 << i for i in range(got.N))]:
        assert got.get_size(node) == ref.get_size(node)


@pytest.mark.parametrize("plan", _PLANS)
def test_plan_lowers_to_the_reference_ir(plan):
    got, ref = _trees(plan)
    assert lowering.extract_contractions(got) == (
        ref_lowering.extract_contractions(ref)
    )


def test_load_tree_checks_the_instance():
    inputs, output, size_dict = _instance("lattice7x7_d16_s16")
    size_dict = dict(size_dict, **{inputs[0][0]: 8})
    with pytest.raises(ValueError, match="different instance"):
        ctt.load_tree(
            str(ROOT / "plans" / "lattice7x7_d16_s16.json"),
            inputs, output, size_dict,
        )


# -- trees from explicit paths ------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_path_builds_the_reference_tree(seed):
    inputs, output, _, size_dict = ctg.rand_equation(
        14, 3, n_out=2, n_hyper_in=1, seed=seed
    )
    path = ctg.optimize_greedy(inputs, output, size_dict)
    ref = ctg.ContractionTree.from_path(inputs, output, size_dict, path=path)
    got = ctt.ContractionTree.from_path(inputs, output, size_dict, path=path)
    assert list(got.children.items()) == list(ref.children.items())
    ssa = ref.get_ssa_path()
    got2 = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    ref2 = ctg.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    assert list(got2.children.items()) == list(ref2.children.items())
    # slicing and projection, as the reference does them
    for ix, project in [(inputs[3][0], None), (inputs[5][-1], 1)]:
        got.remove_ind_(ix, project=project)
        ref.remove_ind_(ix, project=project)
    assert _sliced(got) == _sliced(ref)
    assert got.multiplicity == ref.multiplicity
    assert lowering.extract_contractions(got) == (
        ref_lowering.extract_contractions(ref)
    )
    assert got.total_flops("float64") == ref.total_flops("float64")
    # the non-inplace form leaves the tree alone
    ix = next(ix for ix in size_dict if ix not in got.sliced_inds)
    before = list(got.sliced_inds)
    sliced = got.remove_ind(ix)
    assert list(got.sliced_inds) == before and ix in sliced.sliced_inds
    assert sliced.multiplicity == got.multiplicity * size_dict[ix]


def test_from_path_without_a_planner():
    inputs = [("a", "b"), ("b", "c"), ("c", "d"), ("d", "a")]
    size_dict = dict.fromkeys("abcd", 2)
    # a path that leaves two subtrees closes without a planner
    two = [(0, 1), (0, 1)]
    got = ctt.ContractionTree.from_path(inputs, (), size_dict, path=two)
    ref = ctg.ContractionTree.from_path(inputs, (), size_dict, path=two)
    assert list(got.children.items()) == list(ref.children.items())
    assert got.root in got.children
    # more left over are joined by the port's own (native) greedy, as the
    # reference's native greedy joins them
    got = ctt.ContractionTree.from_path(inputs, (), size_dict, path=[])
    ref = ctg.ContractionTree.from_path(
        inputs, (), size_dict, ssa_path=ctg.optimize_greedy(
            inputs, (), size_dict, use_ssa=True
        ),
    )
    assert list(got.children.items()) == list(ref.children.items())
    assert got.is_complete()
    got = ctt.ContractionTree.from_path(
        inputs, (), size_dict, path=[], optimize="optimal"
    )
    assert got.is_complete()
    with pytest.raises(ValueError, match="sub-optimize"):
        ctt.ContractionTree.from_path(
            inputs, (), size_dict, path=[], optimize="kahypar"
        )
    # another traversal order: the ready contractions by priority, as
    # the reference orders them
    ref = ctg.ContractionTree.from_path(
        inputs, (), size_dict, ssa_path=got.get_ssa_path()
    )
    order = lambda node: -node  # noqa: E731
    assert list(got.traverse(order=order)) == list(ref.traverse(order=order))
    assert got.get_ssa_path(order) == ref.get_ssa_path(order)


# -- config -------------------------------------------------------------


def test_config_mirrors_the_reference():
    assert set(config._DEFAULTS) == set(ref_config._DEFAULTS) - {"precision"}
    assert config.get_default("implementation") is None
    with config.default_implementation("pallas"):
        assert config.get_default("implementation") == "pallas"
        # the JAX package's config is another object
        assert ref_config.get_default("implementation") is None
        with config.default_options(slice_batch=4, implementation=None):
            assert config.get_default("slice_batch") == 4
            assert config.get_default("implementation") is None
        assert config.get_default("slice_batch") is None
    assert config.get_default("implementation") is None
    with pytest.raises(KeyError):
        config.set_default("precision", "highest")


def test_package_exports_its_own_builders():
    assert ctt.ContractionTree.__module__ == "cotengra_tpu_torch.tree"
    assert ctt.load_tree.__module__ == "cotengra_tpu_torch.utils.io"
    assert ctt.rand_circuit_tn.__module__ == (
        "cotengra_tpu_torch.models.circuits"
    )
    assert ctt.lattice_equation.__module__ == (
        "cotengra_tpu_torch.models.instances"
    )
    np.testing.assert_array_equal(
        ctt.rand_circuit_tn(4, 1, seed=0)[4][0], np.array([1, 0])
    )
