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
    REG_BITS,
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


def _cmatmul(x, y):
    """(2, ..., K) @ (2, K, N) on split-complex planes."""
    return torch.stack([x[0] @ y[0] - x[1] @ y[1], x[0] @ y[1] + x[1] @ y[0]])


def _slot_offsets(dims):
    """Offset of each state index (the slots' bits, slot 0 lowest) and
    whether it holds a value: ``dims`` is a register group's ``kdims`` or
    ``ndims``, (2, stride) a slot or (1, 0) where it is empty."""
    n = len(dims)
    off = np.array([sum(d[1] for b, d in enumerate(dims) if v >> b & 1)
                    for v in range(1 << n)], dtype=np.int64)
    empty = sum(1 << b for b, d in enumerate(dims) if d[0] == 1)
    held = np.array([not v & empty for v in range(1 << n)])
    return off, held


def _run_group(g, src, gate_tabs, ys):
    """One register group on gathered inputs ``src`` (2, B, O, inputs):
    the thread's state of 2**slots values, every gate applied to its
    field, as the kernel does in registers. Returns (2, B, O, outputs)."""
    _, held_in = _slot_offsets(g.io.kdims)
    _, held_out = _slot_offsets(g.io.ndims)
    state = src.new_zeros(src.shape[:3] + (1 << g.slots,))
    state[..., torch.from_numpy(held_in)] = src
    for j, (kb, nb, p, pk, pn) in zip(range(*g.gates), g.fields):
        koff, noff = next(gate_tabs)
        assert tuple(koff) == pk and tuple(noff) == pn
        K, N, mb = 1 << kb, 1 << nb, max(kb, nb)
        y = ys[j][:, torch.tensor(pk)][:, :, torch.tensor(pn)]
        st = state.reshape(state.shape[:3] + (-1, 1 << mb, 1 << p))
        res = _cmatmul(st[..., :K, :].transpose(-1, -2), y)
        new = torch.zeros_like(st)
        new[..., :N, :] = res.transpose(-1, -2)
        state = new.reshape(state.shape)
    return state[..., torch.from_numpy(held_out)]


def _emulate(spec, x, ys, smem_bytes=SMEM_BUDGET):
    """The kernel's passes in PyTorch, from the plan's tables alone: the
    gather, then group by group (in registers, or gate by gate on the
    per-item path) from buffer to buffer, the last group writing out."""
    for ps in chain_tile_plan(spec, smem_bytes):
        tabs = pass_tables(ps)
        io = ps.io
        b_in = gate_chains._offsets([(s, i) for s, i, _ in io.batch])
        b_out = gate_chains._offsets([(s, o) for s, _, o in io.batch])
        gather = expand_table(tabs["gather"])
        planes = x.view(2, -1)
        buf = planes[:, torch.from_numpy(b_in[:, None] + gather[None, :])]
        out = x.new_full((2 * io.numel_out,), float("nan"))
        gate_tabs = iter(tabs["gates"])
        for gi, (g, (oin, oout)) in enumerate(zip(ps.groups,
                                                  tabs["groups"])):
            ain, aout = expand_table(oin), expand_table(oout)
            if g.slots is None:
                koff, noff = next(gate_tabs)
                src = buf[:, :, torch.from_numpy(ain[:, None] + koff[None, :])]
                res = _cmatmul(src, ys[g.gates[0]])
                dst = aout[:, None] + noff[None, :]
            else:
                s_in, held_in = _slot_offsets(g.io.kdims)
                s_out, held_out = _slot_offsets(g.io.ndims)
                src = buf[:, :, torch.from_numpy(
                    ain[:, None] + s_in[held_in][None, :])]
                res = _run_group(g, src, gate_tabs, ys)
                dst = aout[:, None] + s_out[held_out][None, :]
            if gi == len(ps.groups) - 1:
                # the last group writes out
                idx = b_out[:, None, None] + dst[None]
                out.view(2, -1)[:, torch.from_numpy(idx)] = res
            else:
                buf = buf.new_full((2, buf.shape[1], g.io.numel_out),
                                   float("nan"))
                buf[:, :, torch.from_numpy(dst)] = res
                assert not torch.isnan(buf).any(), "a tile position unset"
        assert next(gate_tabs, None) is None
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


@pytest.mark.parametrize("smem_bytes,passes", [(6000, 2), (2000, 2), (600, 4)])
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
    """39 passes over the 38 m20 chains: chain 25 (seven gates on 2^25
    elements) outgrows one pass. Chain 12 (eight gates) fits one, since
    its tiles go to work buffers only between its register groups."""
    passes = [len(chain_tile_plan(c[0])) for c in _m20_chains()]
    assert sum(passes) == 39
    assert [ci for ci, n in enumerate(passes) if n > 1] == [25]
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
    # the last group's tables address out itself, each position once
    tabs = pass_tables(ps)
    last = ps.groups[-1]
    oout = tabs["groups"][-1][1]
    if last.slots is None:
        noff = tabs["gates"][-1][1]
    else:
        s_out, held = _slot_offsets(last.io.ndims)
        noff = s_out[held]
    full = (expand_table(oout)[:, None] + noff[None, :]).reshape(-1)
    assert np.array_equal(np.sort(full),
                          np.sort(gate_chains._offsets(ps.io.ndims)))
    _check_groups(spec, ps)


def _check_groups(spec, ps):
    """The groups cover the pass's gates in order; a register group
    holds at most 2**REG_BITS values a thread, every gate's field lies
    in its slots, and its slots cover the tile: the slots' positions
    times the other legs' positions are the tile's, before and after."""
    assert ps.groups[0].gates[0] == ps.gates[0]
    assert ps.groups[-1].gates[1] == ps.gates[1]
    assert all(a.gates[1] == b.gates[0] for a, b in zip(ps.groups,
                                                       ps.groups[1:]))
    for g in ps.groups:
        first, stop = g.gates
        assert g.io.numel_in == ps.tile[first - ps.gates[0]].numel_in
        assert g.io.numel_out == ps.tile[stop - 1 - ps.gates[0]].numel_out
        if g.slots is None:
            assert stop == first + 1
            continue
        assert 0 <= g.slots <= REG_BITS
        assert len(g.io.kdims) == len(g.io.ndims) == g.slots
        assert len(g.fields) == stop - first
        for (kb, nb, p, pk, pn), (_, _, c, ny) in zip(
                g.fields, spec.gate_orders[first:stop]):
            K = prod(spec.leg_sizes[ix] for ix in c)
            N = prod(spec.leg_sizes[ix] for ix in ny)
            assert (1 << kb, 1 << nb) == (K, N)
            assert p + max(kb, nb) <= g.slots
            # each y row and column read once
            assert sorted(pk) == list(range(K))
            assert sorted(pn) == list(range(N))
        others = gate_chains._offsets([(s, i) for s, i, _ in g.io.batch])
        for dims, numel in ((g.io.kdims, g.io.numel_in),
                            (g.io.ndims, g.io.numel_out)):
            off, held = _slot_offsets(dims)
            if dims is g.io.ndims:
                others = gate_chains._offsets(
                    [(s, o) for s, _, o in g.io.batch])
            full = (others[:, None] + off[held][None, :]).reshape(-1)
            assert len(np.unique(full)) == len(full) == numel


def test_split_tables_expand_to_the_full_offsets():
    for dims in [(), ((8, 1),), ((2, 64), (3, 1), (4, 8)),
                 ((2, 1024), (2, 1), (16, 2), (2, 32))]:
        hi, lo = gate_chains._split_dims(dims)
        full = gate_chains._offsets(dims)
        assert np.array_equal(
            expand_table((gate_chains._offsets(hi),
                          gate_chains._offsets(lo))), full)
        assert len(gate_chains._offsets(lo)) <= max(1, len(full))


@pytest.mark.parametrize("ci", [0, 1, 2, 3])
def test_emulated_m20_chains_match_plain_and_reference(ci):
    """m20 chains 0-3 at full size (2^16 - 2^17 elements): register
    groups of 2-4 slots, and chain 3's (8, 32) gate on the per-item path
    after a group."""
    spec, ref_spec, c_orders, sizes = _m20_chains()[ci]
    assert spec.key() == ref_spec.key()
    n = spec.gate_strides[0].numel_in
    x, ys = _inputs(c_orders, sizes, n, 100 + ci)
    _check(spec, ref_spec, x, ys)


# the m20 gates whose legs take more than REG_BITS bits on a side, as
# (chain, gate): (8, 32) and (16, 32) gates and one (32, 8)
M20_ITEM_GATES = [(3, 2), (5, 0), (6, 0), (7, 0), (8, 0), (33, 4)]


def test_m20_gates_run_in_register_groups():
    """Every m20 gate whose contracted and created legs take at most
    REG_BITS bits each runs in a register group (141 of 147); the six
    wider ones stay on the per-item path; no group holds more than
    2**REG_BITS values a thread; 110 groups in the 39 passes."""
    item, n_gates, n_groups = [], 0, 0
    for ci, (spec, _, _, _) in enumerate(_m20_chains()):
        for ps in chain_tile_plan(spec):
            n_groups += len(ps.groups)
            for g in ps.groups:
                n_gates += g.gates[1] - g.gates[0]
                assert g.slots is None or g.slots <= REG_BITS
                if g.slots is None:
                    item.append((ci, g.gates[0]))
            reg, n_item, groups = gate_chains.group_counts(ps)
            assert (reg + n_item, groups) == (ps.gates[1] - ps.gates[0],
                                              len(ps.groups))
    assert item == M20_ITEM_GATES
    assert (n_gates, n_groups) == (147, 110)
    for ci, j in item:
        _, _, c, ny = _m20_chains()[ci][0].gate_orders[j]
        assert max(len(c), len(ny)) > REG_BITS


def test_t27_gates_run_in_register_groups():
    counts = [gate_chains.group_counts(ps)
              for spec, _, _, _ in _t27_chains()
              for ps in chain_tile_plan(spec)]
    assert sum(c[0] for c in counts) == 33
    assert sum(c[1] for c in counts) == 2
    assert sum(c[2] for c in counts) == 24


@pytest.mark.parametrize("chains", ["t27", "m20"])
def test_pass_smem_is_the_kernel_layout(chains):
    """``_pass_smem_bytes`` counts the arrays that the kernel lays out
    from the argument block: the gates' y, the ring slots and work
    buffers (one where the ring slot takes every other tile between
    groups), the batch offsets and the index tables it is handed."""
    specs = _t27_chains() if chains == "t27" else _m20_chains()
    for spec, _, _, _ in specs:
        for ps in chain_tile_plan(spec):
            meta, tables = gate_chains._pass_kernel_args(ps)
            ngates, E, S, _, t_work = meta[:5]
            assert meta[8] == len(tables)
            at = gate_chains._META_Y
            kn = [tuple(meta[at + gate_chains._META_GATE * j + 1:
                             at + gate_chains._META_GATE * j + 3])
                  for j in range(ngates)]
            t_in = meta[at + 3]
            n_work = meta[16]
            # the tiles between groups fit the buffers they go to
            room = [t_work, t_in] if n_work == 1 else [t_work, t_work]
            for j, g in enumerate(ps.groups[:-1]):
                assert g.io.numel_out <= room[j % 2]
            assert gate_chains._pass_smem_bytes(
                t_in, t_work, n_work, kn, len(tables), E, S
            ) == ps.smem_bytes


def test_kron_gate_stays_on_the_per_item_path():
    """A K*N = 512 gate (a kron-fused pair of gates, as ``fuse_gates``
    makes them, at MAX_GATE_COMBOS) has more bits than a register group
    holds: it runs alone on the per-item path, and small gates around
    it form register groups."""
    order0, sizes, gates = _gates(
        17, [((0, 1), 2), ((1, 5, 6, 15, 16), 4), ((2, 3), 2)])
    spec, _, _ = build_chain_spec(order0, sizes, gates)
    (ps,) = chain_tile_plan(spec)
    assert [(g.gates, g.slots) for g in ps.groups] == [
        ((0, 1), 2), ((1, 2), None), ((2, 3), 2)]
    assert gate_chains.group_counts(ps) == (2, 1, 3)
    K, N = (prod(d[0] for d in ps.tile[1].kdims),
            prod(d[0] for d in ps.tile[1].ndims))
    assert K * N == gate_chains.MAX_GATE_COMBOS


@pytest.mark.parametrize("picks", [
    [((0, 1), 2), ((14, 15), 2), ((15, 16), 2)],
    [((15, 16), 2), ((1, 2), 2), ((14, 15), 2), ((16, 15), 2)],
])
def test_emulated_strided_last_group_matches_plain_and_reference(picks):
    """A pass whose last register group makes out's innermost legs stores
    to out a stride apart, straight from its registers."""
    order0, sizes, gates = _gates(17, picks)
    ref_spec, _, c_orders = ref_gates.build_chain_spec(order0, sizes, gates)
    spec, _, _ = build_chain_spec(order0, sizes, gates)
    (ps,) = chain_tile_plan(spec)
    last = ps.groups[-1]
    assert len(ps.groups) > 1 and last.slots is not None
    assert last.io.batch[-1][2] >= 4
    x, ys = _inputs(c_orders, sizes, 2**17, len(picks))
    _check(spec, ref_spec, x, ys)
