"""The port's host-side planning makes the reference's decisions:
lowering, absorption, grouped step plans and gate-chain specs are equal
to the JAX package's on the same trees."""

import numpy as np
import pytest
import torch

import cotengra_tpu as ctg
from cotengra_tpu.models.circuits import rand_circuit_tn
from cotengra_tpu.ops import grouped as ref_grouped
from cotengra_tpu.ops import lowering as ref_lowering
from cotengra_tpu.ops import pallas_gates as ref_gates
from cotengra_tpu.ops import preprocess as ref_preprocess
from cotengra_tpu.utils.io import load_tree

from cotengra_tpu_torch.ops import gate_chains, grouped_plan, lowering
from cotengra_tpu_torch.ops import preprocess

torch.set_num_threads(1)


def _absorbed(nq, depth, seed, **kw):
    inputs, output, _, _, arrays = rand_circuit_tn(nq, depth, seed=seed)
    ref = ref_preprocess.absorb_simple_tensors(inputs, arrays, output, **kw)
    got = preprocess.absorb_simple_tensors(inputs, arrays, output, **kw)
    assert got[0] == ref[0]
    assert len(got[1]) == len(ref[1])
    for a, b in zip(got[1], ref[1]):
        assert a.shape == b.shape and np.array_equal(a, b)
    inputs, arrays = got
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    return inputs, output, size_dict


def _circuit_tree(nq, depth, seed, nslice):
    inputs, output, size_dict = _absorbed(nq, depth, seed)
    ssa, _ = ctg.optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=8, seed=seed, use_ssa=True
    )
    tree = ctg.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    if nslice > 1:
        tree.slice_(target_slices=nslice)
    return tree


def _gate_tree():
    """18 size-2 axes with 2-qubit gates at leading, middle, trailing and
    mixed positions (the reference's in-place chain construction)."""
    n = 18
    state = [f"a{k}" for k in range(n)]
    inputs = [tuple(state)]
    cur = list(state)
    nxt = 0
    for i, j in [(0, 1), (5, 6), (16, 17), (2, 12), (8, 9), (13, 17)]:
        bi, bj = f"b{nxt}", f"b{nxt + 1}"
        nxt += 2
        inputs.append((bi, bj, cur[i], cur[j]))
        cur[i], cur[j] = bi, bj
    size_dict = {ix: 2 for t in inputs for ix in t}
    return ctg.ContractionTree.from_path(
        inputs, tuple(cur), size_dict, path=[(0, 1)] * (len(inputs) - 1)
    )


def _sycamore_tree(m, t):
    inputs, output, size_dict = _absorbed(
        53, m, 42, max_rank=2, max_absorb_size=2**12
    )
    return load_tree(
        f"plans/sycamore53_m{m}_t{t}.json", inputs, output, size_dict
    )


_PAIR_SLOTS = ref_grouped._GroupedPair.__slots__


def _canon(res):
    """Plain-data form of a plan_grouped result, comparable across
    packages."""
    plans, storage, out_plan, out_shape, last_use = res
    out = []
    for kind, info in plans:
        if kind == "pair":
            rec = tuple(getattr(info, s) for s in _PAIR_SLOTS)
        elif kind == "inplace":
            rec = (info.x_id, info.out_id, info.spec.key(), info.ys,
                   info.out_order, info.out_shape)
        else:  # single: a SingleStep; fallback: a tuple with a PairStep
            rec = tuple(info)
        out.append((kind, rec))
    return out, storage, out_plan, out_shape, last_use


def _assert_same_plans(tree):
    ref_ir = ref_lowering.extract_contractions(tree)
    ir = lowering.extract_contractions(tree)
    assert ir == ref_ir
    orders = [lowering.sliced_input_legs(tree, i) for i in range(tree.N)]
    assert orders == [
        ref_lowering.sliced_input_legs(tree, i) for i in range(tree.N)
    ]
    kinds = set()
    for mode in (None, "inplace"):
        ref = ref_grouped.plan_grouped(
            ref_ir, tree.size_dict, orders, gate_mode=mode
        )
        got = grouped_plan.plan_grouped(
            ir, tree.size_dict, orders, gate_mode=mode
        )
        assert _canon(got) == _canon(ref)
        kinds |= {k for k, _ in got[0]}
    return kinds


@pytest.mark.parametrize(
    "nq,depth,seed,nslice",
    [(12, 4, 0, 1), (16, 6, 1, 4), (20, 8, 2, 2), (26, 10, 3, 1)],
)
def test_plans_equal_on_random_circuits(nq, depth, seed, nslice):
    _assert_same_plans(_circuit_tree(nq, depth, seed, nslice))


def test_plans_equal_on_gate_construction():
    kinds = _assert_same_plans(_gate_tree())
    assert "inplace" in kinds


@pytest.mark.parametrize(
    "m,t,chains",
    [(10, 27, 13), (10, 29, 0), (20, 28, None)],
)
def test_plans_equal_on_committed_sycamore_plans(m, t, chains):
    tree = _sycamore_tree(m, t)
    _assert_same_plans(tree)
    if chains is not None:
        ir = lowering.extract_contractions(tree)
        orders = [lowering.sliced_input_legs(tree, i) for i in range(tree.N)]
        plans = grouped_plan.plan_grouped(
            ir, tree.size_dict, orders, gate_mode="inplace"
        )[0]
        assert sum(k == "inplace" for k, _ in plans) == chains


def _random_gates(rng, n, ngates):
    order0 = tuple(f"a{k}" for k in range(n))
    sizes = {ix: 2 for ix in order0}
    cur = list(order0)
    gates = []
    for g in range(ngates):
        k = int(rng.integers(1, 4))
        c = tuple(rng.choice(cur, size=k, replace=False))
        ny = tuple(f"g{g}_{j}" for j in range(int(rng.integers(1, 4))))
        for ix in ny:
            sizes[ix] = 2
        cur = [ix for ix in cur if ix not in c] + list(ny)
        gates.append((c, ny))
    return order0, sizes, gates


@pytest.mark.parametrize("seed", range(8))
def test_chain_specs_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(13, 20))
    order0, sizes, gates = _random_gates(rng, n, int(rng.integers(1, 5)))
    for k in range(1, len(gates) + 1):
        ref = ref_gates.build_chain_spec(order0, sizes, gates[:k])
        got = gate_chains.build_chain_spec(order0, sizes, gates[:k])
        if ref[0] is None:
            assert got == ref  # same rejection reason
            continue
        assert got[0].key() == ref[0].key()
        assert got[1:] == ref[1:]
        # the recorded per-gate tables cover every leg exactly once
        for g in got[0].gate_strides:
            numel = np.prod([d[0] for d in g.batch + g.kdims] or [1])
            assert numel == g.numel_in


def test_unported_gate_modes_raise():
    tree = _gate_tree()
    ir = lowering.extract_contractions(tree)
    orders = [lowering.sliced_input_legs(tree, i) for i in range(tree.N)]
    with pytest.raises(ValueError, match="not ported"):
        grouped_plan.plan_grouped(
            ir, tree.size_dict, orders, gate_mode="window"
        )
