"""Whole sliced contractions: the port on CPU float64 planes equals the
JAX grouped split-complex executor (in-place chains in Pallas interpret
mode, plane I/O) and ``tree.contract``."""

import collections

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch.utils._python_dispatch import TorchDispatchMode

import cotengra_tpu as ctg
from cotengra_tpu.models.circuits import rand_circuit_tn
from cotengra_tpu.ops.grouped import make_grouped_staged_contractor

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import grouped

torch.set_num_threads(1)


def _state_network(n=20, seed=0):
    """A 2^n state absorbing, in turn: 2-qubit gates (in-place chains),
    a 64x64 gate on scattered legs (scattered mm), a K=8 -> N=2 gate
    (scattered matvec), a gate on an open leg (bmm), a 64x64 gate on
    leading legs (mm), two vectors, a K=8 -> N=4 gate (matvec), then
    vectors closing every leg but the open one (mac and fallback)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.normal(size=shape) + 1j * rng.normal(size=shape)

    cur = [f"q{k}" for k in range(n)]
    inputs, arrays = [tuple(cur)], [rnd(*(2,) * n)]
    count = [0]

    def gate(pos, nnew, keep=()):
        c = [cur[p] for p in pos]
        ny = []
        for _ in range(nnew):
            count[0] += 1
            ny.append(f"n{count[0]}")
        legs = tuple(ny) + tuple(c) + tuple(keep)
        inputs.append(legs)
        arrays.append(rnd(*(2,) * len(legs)))
        for p, ix in zip(pos, ny):
            cur[p] = ix
        for p in sorted(pos[nnew:], reverse=True):
            del cur[p]

    for i, j in [(0, 1), (5, 6), (18, 19), (2, 12), (8, 9)]:
        gate((i, j), 2)
    gate((1, 2, 6, 7, 9, 10), 6)
    gate((3, 4, 7), 1)
    gate((cur.index("q13"),), 1, keep=("q11",))
    gate((0, 1, 2, 3, 4, 5), 6)
    out = ("q11",)
    for ix in cur[:2]:
        inputs.append((ix,))
        arrays.append(rnd(2))
    del cur[:2]
    gate((0, 1, 2), 2)
    for ix in cur:
        if ix not in out:
            inputs.append((ix,))
            arrays.append(rnd(2))
    size_dict = {ix: 2 for t in inputs for ix in t}
    # state-vector order: absorb every tensor into the state in turn
    nt = len(inputs)
    ssa = [(0, 1)] + [(nt + k, k + 2) for k in range(nt - 2)]
    tree = ctg.ContractionTree.from_path(
        inputs, out, size_dict, ssa_path=ssa
    )
    tree.remove_ind("q15", inplace=True)
    return tree, arrays


def _circuit(nq=20, depth=10, seed=3):
    inputs, output, _, _, arrays = rand_circuit_tn(nq, depth, seed=seed)
    inputs, arrays = ctt.absorb_simple_tensors(inputs, arrays, output)
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    ssa, _ = ctg.optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=8, seed=seed, use_ssa=True
    )
    tree = ctg.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    tree.slice_(target_slices=4)
    return tree, arrays


def _modes(plans):
    out = collections.Counter()
    for kind, info in plans:
        if kind == "pair":
            out[info.mode + ("-scatter" if info.scatter else "")] += 1
        else:
            out[kind] += 1
    return out


@pytest.mark.parametrize(
    "make,modes",
    [
        (
            _state_network,
            {"inplace", "mac", "matvec", "matvec-scatter", "mm",
             "mm-scatter", "bmm", "fallback"},
        ),
        (_circuit, {"fallback"}),
    ],
)
def test_contract_tree_matches_reference(make, modes):
    tree, arrays = make()
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    assert tree.multiplicity > 1
    core = ctt.make_grouped_contractor(tree, "cpu", torch.float64)
    assert modes <= set(_modes(core.plans))

    got = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64
    ).numpy()

    jcore = make_grouped_staged_contractor(
        tree, stage_size=1000, split_complex=True, plane_io=True,
        gate_mode="inplace",
    )
    planes = [ctt.to_plane_array(a) for a in arrays]
    acc = sum(
        np.asarray(jcore(*ctt.slice_arrays(tree, planes, i, axis_offset=1)))
        for i in range(tree.multiplicity)
    )
    assert_allclose(got, acc[0] + 1j * acc[1], rtol=1e-10)
    assert_allclose(got, np.asarray(tree.contract(arrays)), rtol=1e-10)


def test_contractor_without_chains_matches_reference():
    """``gate_mode=None`` plans pairs only: the gates that formed chains
    run as pair steps, to the same result."""
    tree, arrays = _state_network()
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    core = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, gate_mode=None
    )
    modes = set(_modes(core.plans))
    assert "inplace" not in modes
    assert {"mm", "mm-scatter", "matvec-scatter", "fallback"} <= modes

    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    out = ctt.contract_slices(tree, core, planes).numpy()

    jcore = make_grouped_staged_contractor(
        tree, stage_size=1000, split_complex=True, plane_io=True,
        gate_mode=None,
    )
    host_planes = [ctt.to_plane_array(a) for a in arrays]
    acc = sum(
        np.asarray(
            jcore(*ctt.slice_arrays(tree, host_planes, i, axis_offset=1))
        )
        for i in range(tree.multiplicity)
    )
    assert_allclose(out[0] + 1j * out[1], acc[0] + 1j * acc[1], rtol=1e-10)
    assert_allclose(
        out[0] + 1j * out[1], np.asarray(tree.contract(arrays)), rtol=1e-10
    )


def test_slice_arrays_host_matches_planes():
    tree, arrays = _circuit()
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    for i in range(tree.multiplicity):
        host = ctt.slice_arrays(tree, arrays, i)
        dev = ctt.slice_arrays(tree, planes, i, axis_offset=1)
        for h, d in zip(host, dev):
            assert_allclose(d[0].numpy() + 1j * d[1].numpy(), h)


class _CopyDims(TorchDispatchMode):
    """Records the widest tensor of every copy made under it."""

    def __init__(self):
        super().__init__()
        self.dims = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.copy_, torch.ops.aten.clone):
            self.dims.append(
                max(a.dim() for a in args if isinstance(a, torch.Tensor))
            )
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("max_dims", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("seed", range(3))
def test_permute_copy_keeps_each_copy_within_max_dims(max_dims, seed):
    """A permuted copy wider than ``max_dims`` (a CUDA copy takes 25) is
    made in parts, none wider, to the same contiguous tensor."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(d) for d in rng.integers(1, 4, size=6))
    x = torch.from_numpy(rng.normal(size=shape))
    perm = tuple(int(p) for p in rng.permutation(6))
    rec = _CopyDims()
    with rec:
        got = grouped.permute_copy(x, perm, max_dims)
    assert got.is_contiguous() and torch.equal(got, x.permute(perm))
    assert max(rec.dims, default=0) <= max_dims
    # the narrowest output axes go first: 3 levels of binary axes
    if max_dims == 3 and sorted(shape[p] for p in perm[:-1])[:3] == [2] * 3:
        assert len(rec.dims) == 8


@pytest.mark.parametrize("gate_mode", ["inplace", None])
def test_grouped_contractor_with_split_copies(gate_mode, monkeypatch):
    """Block transposes wider than the copy limit (lowered to 3 here, so
    that a small network reaches it) give the same value as whole ones
    and as the reference."""
    tree, arrays = _state_network()
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)

    def run():
        core = ctt.make_grouped_contractor(
            tree, "cpu", torch.float64, gate_mode=gate_mode
        )
        out = ctt.contract_slices(tree, core, planes).numpy()
        return out[0] + 1j * out[1]

    want = run()
    split = []
    copy_permuted = grouped._copy_permuted

    def record(out, src, max_dims):
        split.append(src.dim())
        copy_permuted(out, src, max_dims)

    monkeypatch.setattr(grouped, "MAX_COPY_DIMS", 3)
    monkeypatch.setattr(grouped, "_copy_permuted", record)
    got = run()
    assert max(split, default=0) > 3
    assert_allclose(got, want, rtol=1e-10)
    assert_allclose(got, np.asarray(tree.contract(arrays)), rtol=1e-10)
