"""The PyTorch port stands without JAX, runs on the card by default and
never falls back to the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops.gate_chains import (
    build_chain_spec,
    run_chain,
    run_chain_cuda,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = textwrap.dedent(
    """
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "cotengra_tpu"):
                raise ImportError(name + " is blocked in this test")
            return None

    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, {root!r})

    import numpy as np
    import torch

    torch.set_num_threads(1)

    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.symbols import get_symbol

    def eq(inputs, output):
        sym = {{}}
        for term in list(inputs) + [output]:
            for ix in term:
                sym.setdefault(ix, get_symbol(len(sym)))
        return ",".join(
            "".join(sym[ix] for ix in t) for t in inputs
        ) + "->" + "".join(sym[ix] for ix in output)

    inputs, output, _, _, arrays = ctt.rand_circuit_tn(12, 4, seed=3)
    inputs, arrays = ctt.absorb_simple_tensors(inputs, arrays, output)
    size_dict = {{
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }}
    tree = ctt.ContractionTree.from_path(
        inputs, output, size_dict, path={path!r}
    )
    tree.remove_ind(next(iter(inputs[0])), inplace=True)
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    got = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64
    ).item()
    ref = complex(np.einsum(eq(inputs, output), *arrays, optimize="greedy"))
    assert abs(got - ref) <= 1e-10 * abs(ref), (got, ref)

    # a stripped real contraction through the direct executor
    li, lo, lshapes, lsizes = ctt.lattice_equation([3, 3], d_min=16)
    ltree = ctt.ContractionTree.from_path(li, lo, lsizes, path={lpath!r})
    ltree.remove_ind(li[4][0], inplace=True)
    rng = np.random.default_rng(0)
    larr = [rng.uniform(size=s) for s in lshapes]
    fn = ctt.make_full_contractor(
        ltree, "cpu", strip_exponent=True, implementation="pallas",
        plane_dtype=torch.float64,
    )
    m, e = fn(*ctt.to_tensors(larr, "cpu", torch.float64))
    lref = float(np.einsum(eq(li, lo), *larr, optimize="greedy"))
    lgot = float(m) * 10.0 ** float(e)
    assert abs(lgot - lref) <= 1e-10 * lref, (lgot, lref)

    # the front end plans its own path ("auto": optimal DP below the
    # hardness cutoff, the hyper-optimizer above it) and contracts on the
    # CPU
    for n in (5, 14):
        ei, eo, eshapes, _ = ctt.rand_equation(n, 3, n_out=1, seed=n)
        earr = [rng.uniform(size=s) for s in eshapes]
        egot = ctt.einsum(eq(ei, eo), *earr, device="cpu")
        eref = np.einsum(eq(ei, eo), *earr, optimize="greedy")
        assert egot.dtype == torch.float64
        np.testing.assert_allclose(egot.numpy(), eref, rtol=1e-10)

    # a compressed plan made by the port, contracted with truncation on
    # the CPU; near-product tensors, so chi=9 stays close to the exact
    # value (chi large enough never to truncate)
    ci, co, cshapes, csizes = ctt.lattice_equation([6, 6], d_min=3)
    ctree = ctt.array_contract_tree(
        ci, co, size_dict=csizes, optimize="greedy-compressed"
    )
    assert isinstance(ctree, ctt.ContractionTreeCompressed)
    carr = [np.ones(s) + 0.05 * rng.normal(size=s) for s in cshapes]
    cm, ce = ctree.contract_compressed(
        carr, chi=9, strip_exponent=True, device="cpu"
    )
    cexact = ctree.contract_compressed(carr, chi=10**6, device="cpu")
    clog = np.log10(abs(cm.item())) + ce.item()
    assert abs(clog - np.log10(abs(cexact.item()))) <= 1e-5, clog

    # the port plans a sliced tree itself (the hyper-optimizer, slicing
    # and subtree reconfiguration) and contracts it on the CPU
    hi, ho, hshapes, hsizes = ctt.rand_equation(16, 3, n_out=1, seed=2)
    target = ctt.array_contract_tree(
        hi, ho, size_dict=hsizes, optimize="greedy"
    ).max_size() // 8
    htree = ctt.HyperOptimizer(
        max_repeats=4, seed=1, slicing_reconf_opts={{"target_size": target}}
    ).search(hi, ho, hsizes)
    assert htree.multiplicity > 1 and htree.max_size() <= target
    harr = [rng.uniform(size=s) for s in hshapes]
    hgot = ctt.contract_tree(
        htree, harr, device="cpu", plane_dtype=torch.float64
    )
    href = np.einsum(eq(hi, ho), *harr, optimize="greedy")
    np.testing.assert_allclose(hgot.numpy(), href, rtol=1e-10)

    # the native planning library, built from the port's own source:
    # the reference's seeded native greedy and ctgpart paths
    from pathlib import Path
    from cotengra_tpu_torch.ops import native
    from cotengra_tpu_torch.ops._build import build_dir
    from cotengra_tpu_torch.pathfinders.partition import optimize_ctgpart

    assert native.is_available(), native.build_error()
    assert Path(native.library()._name).parent == build_dir()
    assert native._SRC.parent == Path(ctt.__file__).parent / "ops" / "native"
    ni, no, _, nsizes = ctt.rand_equation(30, 3, n_out=2, seed=5)
    assert ctt.optimize_greedy(
        ni, no, nsizes, temperature=0.3, seed=9, accel=True
    ) == {gpath!r}
    assert optimize_ctgpart(ni, no, nsizes, parts=3, seed=4) == {cpath!r}

    # a lone process is a mesh of size 1; a folded expression; instance
    # and tree files
    import io
    from cotengra_tpu_torch.parallel import mesh as pmesh

    assert not pmesh.maybe_init_distributed()
    mesh1 = pmesh.get_default_mesh(devices="cpu")
    sgot = pmesh.contract_sharded(
        tree, arrays, mesh=mesh1, plane_dtype=torch.float64
    ).item()
    assert abs(sgot - ref) <= 1e-10 * abs(ref), (sgot, ref)
    fexpr = ctt.einsum_expression(
        eq(li, lo), *lshapes, optimize=ltree, device="cpu",
        strip_exponent=True, implementation="pallas",
        constants={{i: larr[i] for i in range(1, len(larr))}},
    )
    for _ in range(2):
        fm, fe = fexpr(larr[0])
        assert abs(float(fm) * 10.0 ** float(fe) - lref) <= 1e-10 * lref
    buf = io.StringIO()
    ctt.save_tree(buf, ltree)
    buf.seek(0)
    assert ctt.load_tree(buf, li, lo, lsizes).children == ltree.children

    import chip_smoke  # imported, not run

    bad = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "cotengra_tpu")
    )
    assert not bad, bad
    print("NO_JAX_OK", tree.multiplicity, ltree.multiplicity)
    """
)


def _reference_paths():
    """Paths planned by the JAX package's greedy optimizer (and its
    seeded native greedy and ctgpart), handed to the blocked subprocess as
    literals: the trees the JAX package would run."""
    from cotengra_tpu import lattice_equation, optimize_greedy, rand_equation
    from cotengra_tpu.models.circuits import rand_circuit_tn
    from cotengra_tpu.pathfinders.partition import optimize_ctgpart

    inputs, output, _, _, arrays = rand_circuit_tn(12, 4, seed=3)
    inputs, arrays = ctt.absorb_simple_tensors(inputs, arrays, output)
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    path = optimize_greedy(inputs, output, size_dict)
    li, lo, _, lsizes = lattice_equation([3, 3], d_min=16)
    ni, no, _, nsizes = rand_equation(30, 3, n_out=2, seed=5)
    return (
        tuple(map(tuple, path)),
        tuple(map(tuple, optimize_greedy(li, lo, lsizes))),
        optimize_greedy(ni, no, nsizes, temperature=0.3, seed=9, accel=True),
        optimize_ctgpart(ni, no, nsizes, parts=3, seed=4),
    )


def test_port_runs_without_jax():
    """The port runs with jax, jaxlib and the JAX package all blocked:
    sliced and stripped contractions, ``einsum`` planning its own path,
    a compressed plan contracted with truncation, a sliced plan that
    the port's hyper-optimizer makes, and a native greedy path and a
    ``ctgpart`` path from the port's own native library."""
    path, lpath, gpath, cpath = _reference_paths()
    proc = subprocess.run(
        [sys.executable, "-c",
         _NO_JAX.format(root=ROOT, path=path, lpath=lpath, gpath=gpath,
                        cpath=cpath)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK 2 16" in proc.stdout


_NO_PLOT_PACKAGES = textwrap.dedent(
    """
    import sys

    BLOCKED = ("jax", "jaxlib", "cotengra_tpu", "matplotlib", "networkx",
               "pandas", "altair")

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(name + " is blocked in this test")
            return None

    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, {root!r})

    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import plot, schematic
    from cotengra_tpu_torch.slicing import SliceFinder

    methods = {{
        ctt.ContractionTree: (
            "plot_tree", "plot_ring", "plot_tent", "plot_span", "plot_flat",
            "plot_rubberband", "plot_circuit", "plot_contractions",
            "plot_contractions_alt", "to_networkx", "to_df",
        ),
        ctt.HyperOptimizer: (
            "plot_trials", "plot_trials_alt", "plot_scatter",
            "plot_scatter_alt", "plot_parameters_parallel",
        ),
        SliceFinder: ("plot_slicings", "plot_slicings_alt"),
        ctt.HyperGraph: ("plot",),
    }}
    n = 0
    for cls, names in methods.items():
        for name in names:
            assert getattr(cls, name).__module__ == plot.__name__, name
            n += 1

    inputs, output, _, size_dict = ctt.rand_equation(14, 3, seed=0)
    tree = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                   optimize="greedy")
    leaves = plot._leaf_angles(tree)
    assert sorted(leaves) == list(tree.gen_leaves())
    ring = plot._tree_positions(tree, "ring")
    tent = plot._tree_positions(tree, "tent")
    assert len(ring) == len(tent) == 2 * tree.N - 1
    for p in tree.children:
        x, y = ring[p]
        assert x * x + y * y < 1
        assert tent[p][1] == p.bit_count() / tree.N
    hull = plot._convex_hull([ring[leaf] for leaf in leaves])
    assert len(hull) == tree.N
    assert len(schematic.auto_colors(5)) == 5

    raised = {{}}
    hg = ctt.get_hypergraph(inputs, output, size_dict)
    for label, call in [
        ("plot_ring", tree.plot_ring),
        ("plot_circuit", tree.plot_circuit),
        ("to_networkx", tree.to_networkx),
        ("to_df", tree.to_df),
        ("hypergraph", hg.plot),
        ("trials_alt", ctt.HyperOptimizer().plot_trials_alt),
    ]:
        try:
            call()
        except ImportError as e:
            raised[label] = str(e)
    assert "matplotlib" in raised["plot_ring"], raised
    assert "matplotlib" in raised["plot_circuit"], raised
    assert "networkx" in raised["to_networkx"], raised
    assert "pandas" in raised["to_df"], raised
    assert "networkx" in raised["hypergraph"], raised
    assert "altair" in raised["trials_alt"], raised
    for name in BLOCKED:
        assert name not in sys.modules, name
    print("NO_PLOT_PACKAGES_OK", n, len(raised))
    """
)


def test_port_imports_and_lays_out_without_the_plot_packages():
    """The card machine's environment: with matplotlib, networkx, pandas
    and altair blocked (and JAX), the port imports, its classes carry the
    plot methods, the tree layouts run, and each plot raises the
    ``ImportError`` of the package it needs."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PLOT_PACKAGES.format(root=ROOT)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_PLOT_PACKAGES_OK 19 6" in proc.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.to_plane_tensors([np.ones(2, np.complex64)], "cuda",
                             torch.float32)


def test_contract_tree_cuda_without_card_raises(no_card):
    inputs = [("a", "b"), ("b", "c")]
    tree = ctt.ContractionTree.from_path(
        inputs, ("a", "c"), {"a": 2, "b": 2, "c": 2}, path=[(0, 1)]
    )
    arrays = [np.eye(2, dtype=np.complex64)] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.contract_tree(tree, arrays, device="cuda")


@pytest.mark.parametrize("device", [None, "meta"])
def test_device_must_be_explicit_and_supported(device, no_card):
    # no device means the card, which raises where there is none; a
    # device type the port does not run on is refused
    error = RuntimeError if device is None else ValueError
    with pytest.raises(error):
        ctt.resolve_device(device)


def test_plane_dtype_checked():
    with pytest.raises(ValueError):
        ctt.to_plane_tensors([np.ones(2)], "cpu", torch.float16)


def test_gate_chain_wrapper_never_falls_back():
    order0 = tuple(f"a{k}" for k in range(14))
    sizes = {ix: 2 for ix in order0 + ("b0", "b1")}
    spec, _, _ = build_chain_spec(order0, sizes, [(("a0", "a1"), ("b0", "b1"))])
    x = torch.zeros(2 * 2**14, device="meta")
    ys = [torch.zeros(2, 4, 4, device="meta")]
    with pytest.raises(ValueError):
        run_chain(spec, x, ys)
    # the kernel wrapper refuses CPU tensors instead of computing them
    with pytest.raises(ValueError):
        run_chain_cuda(spec, torch.zeros(2 * 2**14), [torch.zeros(2, 4, 4)])


def test_kernel_build_stays_inside_the_checkout(monkeypatch, tmp_path):
    from cotengra_tpu_torch.ops import _build

    assert _build.build_dir() == (
        _build._ROOT / "build" / "cotengra_tpu_torch"
    )
    # an installed copy (no repository root around it) has nowhere to build
    monkeypatch.setattr(_build, "_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="not inside a checkout"):
        _build.library_path()
