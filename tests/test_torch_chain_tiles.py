"""The host half of the fused gate-chain kernel (``chain_tile_plan`` and
its index tables), checked on the CPU: a PyTorch emulation of the
kernel's passes - gather each tile by the plan's offsets, apply every
gate through its index maps, the last gate writing out - equals the
plain version and the reference ``run_chain`` in Pallas interpret mode,
and the plan keeps its invariants on every chain of the m=10 t27 and
m=20 t28 plans.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_torch_chains import CASES, _gates

from cotengra_tpu.models.circuits import rand_circuit_tn
from cotengra_tpu.ops import grouped as ref_grouped
from cotengra_tpu.ops import lowering as ref_lowering
from cotengra_tpu.ops import pallas_gates as ref_gates
from cotengra_tpu.ops import preprocess as ref_preprocess
from cotengra_tpu.utils.io import load_tree

from cotengra_tpu_torch.ops import gate_chains, grouped_plan, lowering
from cotengra_tpu_torch.ops.gate_chains import (
    COALESCE_FLOATS,
    SMEM_BUDGET,
    build_chain_spec,
    chain_tile_plan,
    pass_tables,
    run_chain_plain,
)
from cotengra_tpu_torch.utils.misc import prod

torch.set_num_threads(1)

RTOL = 1e-12  # float64: the same products, summed in another order


def expand_table(pair):
    """The full offsets of a ``(hi, lo)`` table pair of ``pass_tables``:
    offset(i) = hi[i // len(lo)] + lo[i % len(lo)]."""
    hi, lo = pair
    return (hi[:, None] + lo[None, :]).reshape(-1)


def _emulate(spec, x, ys, smem_bytes=SMEM_BUDGET):
    """The kernel's passes in PyTorch, from the plan's tables alone."""
    for ps in chain_tile_plan(spec, smem_bytes):
        tabs = pass_tables(ps)
        io = ps.io
        b_in = gate_chains._offsets([(s, i) for s, i, _ in io.batch])
        b_out = gate_chains._offsets([(s, o) for s, _, o in io.batch])
        gather = expand_table(tabs["gather"])
        planes = x.view(2, -1)
        buf = planes[:, torch.from_numpy(b_in[:, None] + gather[None, :])]
        out = x.new_full((2 * io.numel_out,), float("nan"))
        last = len(ps.tile) - 1
        first, stop = ps.gates
        for j, (g, (koff, noff, oin, oout), y) in enumerate(
            zip(ps.tile, tabs["gates"], ys[first:stop])
        ):
            src = buf[:, :, torch.from_numpy(
                expand_table(oin)[:, None] + koff[None, :])]
            res = torch.stack([src[0] @ y[0] - src[1] @ y[1],
                               src[0] @ y[1] + src[1] @ y[0]])
            dst = expand_table(oout)[:, None] + noff[None, :]
            if j == last:  # the last gate writes out
                idx = b_out[:, None, None] + dst[None]
                out.view(2, -1)[:, torch.from_numpy(idx)] = res
            else:
                buf = buf.new_empty(2, buf.shape[1], g.numel_out)
                buf[:, :, torch.from_numpy(dst)] = res
        assert not torch.isnan(out).any(), "a position of out was not written"
        x = out
    return x


def _inputs(c_orders, sizes, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2 * n)
    ys = [
        rng.standard_normal((2, prod(sizes[ix] for ix in c),
                             prod(sizes[ix] for ix in ny)))
        for c, ny in c_orders
    ]
    return x, ys


def _check(spec, ref_spec, x, ys, smem_bytes=SMEM_BUDGET):
    xt, yt = torch.from_numpy(x), [torch.from_numpy(y) for y in ys]
    got = _emulate(spec, xt, yt, smem_bytes).numpy()
    plain = run_chain_plain(spec, xt, yt).numpy()
    ref = np.asarray(ref_gates.run_chain(
        ref_spec, jnp.asarray(x), [jnp.asarray(y) for y in ys],
        interpret=True,
    ))
    atol = RTOL * np.abs(ref).max()
    assert_allclose(got, plain, rtol=RTOL, atol=atol)
    assert_allclose(got, ref, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_passes_match_plain_and_reference(case):
    n, picks = CASES[case]
    order0, sizes, gates = _gates(n, picks)
    ref_spec, _, c_orders = ref_gates.build_chain_spec(order0, sizes, gates)
    spec, _, _ = build_chain_spec(order0, sizes, gates)
    assert spec.key() == ref_spec.key()
    x, ys = _inputs(c_orders, sizes, 2**n, sum(map(ord, case)))
    _check(spec, ref_spec, x, ys)


@functools.lru_cache(maxsize=None)
def _plan_chains(m, t):
    """Per in-place chain of the Sycamore-53 m t plan: (port spec,
    reference spec, c_orders, leg sizes), from both packages' own
    planners."""
    inputs, output, _, _, arrays = rand_circuit_tn(53, m, seed=42)
    inputs, arrays = ref_preprocess.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    tree = load_tree(f"plans/sycamore53_m{m}_t{t}.json", inputs, output,
                     size_dict)
    orders = [lowering.sliced_input_legs(tree, i) for i in range(tree.N)]
    ours = grouped_plan.plan_grouped(
        lowering.extract_contractions(tree), tree.size_dict, orders,
        gate_mode="inplace",
    )[0]
    refs = ref_grouped.plan_grouped(
        ref_lowering.extract_contractions(tree), tree.size_dict, orders,
        gate_mode="inplace",
    )[0]
    out = []
    for (kind, rec), (_, ref) in zip(ours, refs):
        if kind == "inplace":
            c_orders = [o[2:] for o in rec.spec.gate_orders]
            out.append((rec.spec, ref.spec, c_orders, tree.size_dict))
    return out


def _t27_chains():
    out = _plan_chains(10, 27)
    assert len(out) == 13
    return out


def _m20_chains():
    out = _plan_chains(20, 28)
    assert len(out) == 38
    return out


@pytest.mark.parametrize("ci", [0, 1, 2])
def test_emulated_t27_chains_match_plain_and_reference(ci):
    """t27 chains 0-2 at full size (2^16 - 2^17 elements)."""
    spec, ref_spec, c_orders, sizes = _t27_chains()[ci]
    assert spec.key() == ref_spec.key()
    n = spec.gate_strides[0].numel_in
    x, ys = _inputs(c_orders, sizes, n, ci)
    _check(spec, ref_spec, x, ys)


@pytest.mark.parametrize("smem_bytes,passes", [(8000, 2), (2000, 2), (800, 4)])
def test_small_budget_splits_into_passes(smem_bytes, passes):
    """A budget too small for the chain's tile: several passes, the
    same result."""
    order0, sizes, gates = _gates(17, [((0, 1), 2), ((2, 3), 2),
                                       ((4, 5), 2), ((15, 16), 2)])
    ref_spec, _, c_orders = ref_gates.build_chain_spec(order0, sizes, gates)
    spec, _, _ = build_chain_spec(order0, sizes, gates)
    plan = chain_tile_plan(spec, smem_bytes)
    assert len(plan) == passes
    assert all(ps.smem_bytes <= smem_bytes for ps in plan)
    assert [ps.gates for ps in plan] == sorted(ps.gates for ps in plan)
    assert plan[0].gates[0] == 0 and plan[-1].gates[1] == len(gates)
    assert all(a.gates[1] == b.gates[0] for a, b in zip(plan, plan[1:]))
    x, ys = _inputs(c_orders, sizes, 2**17, 3)
    _check(spec, ref_spec, x, ys, smem_bytes)


def test_gate_beyond_the_budget_raises():
    order0, sizes, gates = _gates(17, [((0, 1), 2)])
    spec, _, _ = build_chain_spec(order0, sizes, gates)
    with pytest.raises(ValueError, match="does not fit"):
        chain_tile_plan(spec, 100)


def _contiguous_run(offsets):
    """How many leading offsets run 0, 1, 2, ..."""
    steps = np.flatnonzero(offsets != np.arange(len(offsets)))
    return int(steps[0]) if len(steps) else len(offsets)


def _check_tile_plan(spec):
    """The invariants of every pass of ``chain_tile_plan(spec)``; returns
    the plan."""
    plan = chain_tile_plan(spec)
    assert plan[0].gates[0] == 0 and plan[-1].gates[1] == len(spec.gate_orders)
    assert all(a.gates[1] == b.gates[0] for a, b in zip(plan, plan[1:]))
    for ps in plan:
        _check_pass(spec, ps)
        # a pass ends where one more gate would not fit
        first, stop = ps.gates
        if stop < len(spec.gate_orders):
            assert gate_chains._make_pass(spec, first, stop + 1,
                                          SMEM_BUDGET) is None
    return plan


@pytest.mark.parametrize("ci", range(13))
def test_t27_tile_plan_invariants(ci):
    spec, _, _, sizes = _t27_chains()[ci]
    plan = _check_tile_plan(spec)
    assert len(plan) == 1  # the whole chain in one pass


@pytest.mark.parametrize("ci", range(38))
def test_m20_tile_plan_invariants(ci):
    spec, _, _, sizes = _m20_chains()[ci]
    _check_tile_plan(spec)


def test_m20_tile_plan_passes():
    """40 passes over the 38 m20 chains: chains 12 and 25 (seven and
    eight gates on 2^25 elements) outgrow one pass."""
    passes = [len(chain_tile_plan(c[0])) for c in _m20_chains()]
    assert sum(passes) == 40
    assert [ci for ci, n in enumerate(passes) if n > 1] == [12, 25]
    assert max(passes) == 2


def _check_pass(spec, ps):
    first, stop = ps.gates
    assert ps.smem_bytes <= SMEM_BUDGET
    legs = set(ps.legs)
    for o_in, o_out, c, ny in spec.gate_orders[first:stop]:
        assert set(c) | set(ny) <= legs  # the tile covers every gate
    n_batch = prod(d[0] for d in ps.io.batch)
    tile_in = prod(d[0] for d in ps.io.kdims)
    tile_out = prod(d[0] for d in ps.io.ndims)
    assert tile_in == ps.tile[0].numel_in and tile_out == ps.tile[-1].numel_out
    assert n_batch * tile_in == spec.gate_strides[first].numel_in
    assert n_batch * tile_out == spec.gate_strides[stop - 1].numel_out
    assert 1 <= ps.batch_tile <= n_batch and 2 <= ps.stages <= 4
    # loads and stores coalesce: the tile holds x's and out's innermost
    # 32 floats, unless one more leg (doubling every tile) would not fit
    # the budget even without the index tables and at a two-deep ring
    t_in = ps.tile[0].numel_in
    t_work = max([g.numel_in for g in ps.tile[1:]] or [0])
    doubled = gate_chains._pass_smem_bytes(
        2 * t_in, 2 * t_work, min(2, len(ps.tile) - 1),
        [(prod(d[0] for d in g.kdims), prod(d[0] for d in g.ndims))
         for g in ps.tile], 0, 1, 2)
    for dims in (ps.io.kdims, ps.io.ndims):
        run = _contiguous_run(gate_chains._offsets(dims))
        assert run >= COALESCE_FLOATS or doubled > SMEM_BUDGET
    # the last gate's tables address out itself
    tabs = pass_tables(ps)
    koff, noff, oin, oout = tabs["gates"][-1]
    full = (expand_table(oout)[:, None] + noff[None, :]).reshape(-1)
    assert np.array_equal(np.sort(full),
                          np.sort(gate_chains._offsets(ps.io.ndims)))


def test_split_tables_expand_to_the_full_offsets():
    for dims in [(), ((8, 1),), ((2, 64), (3, 1), (4, 8)),
                 ((2, 1024), (2, 1), (16, 2), (2, 32))]:
        hi, lo = gate_chains._split_dims(dims)
        full = gate_chains._offsets(dims)
        assert np.array_equal(
            expand_table((gate_chains._offsets(hi),
                          gate_chains._offsets(lo))), full)
        assert len(gate_chains._offsets(lo)) <= max(1, len(full))
