"""Folded expression constants: an ``Expression`` with constants runs
the steps that only constants reach, and no sliced index, once per
device, dtype and options, and keeps their results; every later call
runs only the other steps. Its values equal the unfolded call (CPU
float64, rtol 1e-12) and the JAX package's ``Expression`` with the same
constants (rtol 1e-10), on the direct and the grouped route, stripped
and not, slice by slice and batched."""

import io

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import executor, grouped
from cotengra_tpu_torch.ops.lowering import extract_contractions
from cotengra_tpu_torch.ops.slices import SliceBatch

torch.set_num_threads(1)

VARIABLES = (0, 1)  # the expression's variable inputs; the rest are constant


def _instance(seed):
    """A sliced 14-tensor contraction (9 slices at seed 0) with one
    output index and float64 inputs, planned by the reference: its tree
    and the port's copy (through ``save_tree`` / ``load_tree``)."""
    inputs, output, shapes, size_dict = ctg.rand_equation(
        14, 3, n_out=1, seed=seed
    )
    ref = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    ref.slice_(target_slices=4)
    buf = io.StringIO()
    ctg.save_tree(buf, ref)
    buf.seek(0)
    tree = ctt.load_tree(buf, ref.inputs, ref.output, ref.size_dict)
    rng = np.random.default_rng(seed)
    return ref, tree, [rng.normal(size=s) for s in shapes]


def _split(arrays):
    consts = {i: a for i, a in enumerate(arrays) if i not in VARIABLES}
    return consts, [arrays[i] for i in VARIABLES]


def _value(res):
    if isinstance(res, tuple):
        m, e = (np.asarray(r) for r in res)
        return m * 10.0 ** e
    return np.asarray(res)


@pytest.fixture
def step_count(monkeypatch):
    """Steps run by either executor, counted where they run."""
    count = [0]

    def counting(real):
        def run(plan, steps, *args, **kwargs):
            steps = list(steps)
            count[0] += len(steps)
            return real(plan, steps, *args, **kwargs)
        return run

    monkeypatch.setattr(executor, "_run_ir_steps",
                        counting(executor._run_ir_steps))
    monkeypatch.setattr(grouped, "_exec_steps_split",
                        counting(grouped._exec_steps_split))
    return count


OPTIONS = [
    {},
    {"strip_exponent": True},
    {"slice_batch": 4},
    {"strip_exponent": True, "slice_batch": 3},
    {"implementation": "grouped"},
    {"implementation": "grouped", "strip_exponent": True},
    {"implementation": "grouped", "slice_batch": 4},
    {"implementation": "grouped", "strip_exponent": True, "slice_batch": 9},
]


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize(
    "opts", OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items())
    or "plain"
)
def test_folded_expression_matches_unfolded_and_reference(opts, seed):
    rtree, tree, arrays = _instance(seed)
    consts, variables = _split(arrays)
    ref = ctg.interface.Expression(rtree, constants=consts, **opts)
    expr = ctt.interface.Expression(tree, constants=consts, device="cpu",
                                    **opts)
    rng = np.random.default_rng(100 + seed)
    for call in range(3):
        if call:
            variables = [rng.normal(size=a.shape) for a in variables]
        full = list(arrays)
        for i, a in zip(VARIABLES, variables):
            full[i] = a
        got = expr(*variables)
        unfolded = tree.contract(full, device="cpu", plane_dtype=torch.float64,
                                 **opts)
        assert isinstance(got, tuple) == bool(opts.get("strip_exponent"))
        assert_allclose(_value(got), _value(unfolded), rtol=1e-12, atol=0)
        assert_allclose(_value(got), _value(ref(*variables)), rtol=1e-10,
                        atol=0)
    # one folded contractor for this device, dtype and options
    assert len(expr._folded) == 1


@pytest.mark.parametrize("implementation", [None, "grouped"])
@pytest.mark.parametrize("slice_batch", [None, 3])
def test_later_calls_skip_the_folded_steps(step_count, implementation,
                                           slice_batch):
    """The first call runs the folded steps, every later call only the
    others: fewer steps than the unfolded call, by exactly the folded
    set on every call after the first."""
    _, tree, arrays = _instance(0)
    consts, variables = _split(arrays)
    ir = extract_contractions(tree)
    batch = SliceBatch(tree, list(executor._ir_step_io(ir)), ir.last_use,
                       set(consts))
    assert batch.steps_fold and batch.steps_once and batch.steps_each
    opts = dict(implementation=implementation, slice_batch=slice_batch)
    expr = ctt.interface.Expression(tree, constants=consts, device="cpu",
                                    **opts)
    counts = []
    for _ in range(3):
        step_count[0] = 0
        expr(*variables)
        counts.append(step_count[0])
    step_count[0] = 0
    tree.contract(arrays, device="cpu", plane_dtype=torch.float64, **opts)
    unfolded = step_count[0]
    fn, = expr._folded.values()
    n_fold = len(fn.batch.steps_fold)
    assert n_fold > 0
    assert counts[1] == counts[2] == counts[0] - n_fold
    assert counts[1] < unfolded


def test_batched_call_keeps_working_with_constants():
    """A ``slice_batch`` expression with constants gives the unbatched
    value, and a constant that a sliced index touches is selected per
    slice from its device copy."""
    _, tree, arrays = _instance(2)
    consts, variables = _split(arrays)
    sliced = set(tree.sliced_inds)
    assert any(sliced & set(tree.inputs[i]) for i in consts)
    base = ctt.interface.Expression(tree, constants=consts, device="cpu")
    for batch in (1, 2, 8, 100):
        expr = ctt.interface.Expression(tree, constants=consts,
                                        device="cpu", slice_batch=batch)
        assert_allclose(expr(*variables).numpy(),
                        base(*variables).numpy(), rtol=1e-12)


def test_every_input_constant():
    """With no variable input the whole contraction folds: the first
    call runs every slice-invariant step, later calls the rest."""
    _, tree, arrays = _instance(0)
    expr = ctt.interface.Expression(
        tree, constants=dict(enumerate(arrays)), device="cpu"
    )
    exp = tree.contract(arrays, device="cpu", plane_dtype=torch.float64)
    for _ in range(2):
        assert_allclose(expr().numpy(), exp.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="variable arrays"):
        expr(arrays[0])
