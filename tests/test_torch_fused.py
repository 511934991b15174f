"""Fused kron chains (``fuse_gates=True``) against the JAX package's,
under ``gate_mode=None`` and ``"inplace"`` (the reference's chain steps
in Pallas interpret mode): whole contractions plain, stripped and
sliced under ``"scan"`` and ``"vmap"``, float64 planes on the CPU.

The reference rounds each fused chain's kron product to float32, even
under float64 planes (``cotengra_tpu/ops/grouped.py:1649-1650``); the
port keeps the planes' precision. So the port's fused contraction is
held at rtol 1e-10 to the reference's contraction of the same tree
without fusion (the same function, exact in float64), and at
``REF_FUSED_RTOL`` to the reference's fused one, whose float32 gates
leave a relative error of about 1e-7.
"""

import collections

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from cotengra_tpu.ops import grouped as ref_grouped

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import grouped

from test_torch_plans import _circuit_tree
from test_torch_windowed import (
    _chain_instance,
    _per_slice,
    _port_contract,
    _ref_contract,
)

torch.set_num_threads(1)

F64_RTOL = 1e-10  # float64 in both packages, summed in another order
REF_FUSED_RTOL = 1e-6  # the reference's kron products in float32


def _arrays(tree, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=s) + 1j * rng.normal(size=s)
        for s in tree.get_shapes()
    ]


def _circuit():
    tree = _circuit_tree(24, 14, 2, 1)
    return tree, _arrays(tree, 3)


def _circuit_sliced():
    tree = _circuit_tree(24, 14, 2, 4)
    return tree, _arrays(tree, 4)


_CASES = {"chain": _chain_instance, "circuit": _circuit}


def _close(got, want, rtol):
    assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize(
    "case,gate_mode",
    # the chain instance's gates all join in-place chains under
    # "inplace": nothing is left to fuse there
    [("chain", None), ("circuit", None), ("circuit", "inplace")],
)
def test_fused_contraction_matches_reference(case, gate_mode, strip):
    tree, arrays = _CASES[case]()
    core, got = _port_contract(tree, arrays, strip, gate_mode=gate_mode,
                               fuse_gates=True)
    kinds = collections.Counter(k for k, _ in core.plans)
    assert kinds["fusedchain"] >= 1
    if gate_mode == "inplace":
        assert kinds["inplace"] >= 1
    _close(got, _ref_contract(tree, arrays, strip, gate_mode=gate_mode),
           F64_RTOL)
    _close(got, _ref_contract(tree, arrays, strip, fuse_gates=True,
                              gate_mode=gate_mode), REF_FUSED_RTOL)


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("gate_mode", [None, "inplace"])
def test_batched_fused_call_matches_reference(gate_mode, mode, strip):
    """``fn(raw planes, slice_ids)`` with ``fuse_gates=True`` equals the
    reference's batched call without fusion in the same mode, slice by
    slice (ids out of order), and the port's fused contractor slice by
    slice."""
    tree, arrays = _circuit_sliced()
    nsl = tree.multiplicity
    ids = [3, 0, 2]
    ref_fn = ref_grouped.make_grouped_staged_contractor(
        tree, split_complex=True, plane_io=True, slice_batch=nsl,
        slice_batch_mode=mode, strip_exponent=strip, gate_mode=gate_mode,
        plane_dtype=jnp.float64,
    )
    want = _per_slice(ref_fn(
        [jnp.asarray(ctt.to_plane_array(a)) for a in arrays],
        np.asarray(ids),
    ), strip)
    fn = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, strip_exponent=strip, slice_batch=nsl,
        slice_batch_mode=mode, gate_mode=gate_mode, fuse_gates=True,
    )
    assert fn.mode == mode
    assert any(k == "fusedchain" for k, _ in fn.plans)
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    res = fn(planes, ids)
    got = _per_slice(
        tuple(r.numpy() for r in res) if strip else res.numpy(), strip
    )
    core = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, gate_mode=gate_mode, fuse_gates=True
    )
    for g, w, i in zip(got, want, ids):
        _close(g, w, F64_RTOL)
        one = core(*ctt.slice_arrays(tree, planes, i, axis_offset=1))
        _close(g, one[0].numpy() + 1j * one[1].numpy(), 1e-12)


@pytest.mark.parametrize("lead", [((), ()), ((3,), ()), ((), (3,)),
                                  ((3,), (3,))])
def test_kron_broadcasts_a_slice_dim(lead):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=lead[0] + (2, 3)))
    b = torch.from_numpy(rng.normal(size=lead[1] + (4, 2)))
    got = grouped._kron(a, b)
    assert got.shape == (lead[0] or lead[1]) + (8, 6)
    for s in range(3 if lead != ((), ()) else 1):
        ai = a[s] if a.dim() == 3 else a
        bi = b[s] if b.dim() == 3 else b
        gi = got[s] if got.dim() == 3 else got
        assert torch.equal(gi, torch.kron(ai, bi))
