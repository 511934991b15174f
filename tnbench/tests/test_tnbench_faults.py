"""Whole runs of the tiny cells on the CPU with the timed path broken
underneath: each fault that a cell can have turns ``correct`` false.
(The cells run on one card, so there is no exchange between cards to
leave out.) The sound program, and the control's readings, beside
them."""

import pytest
import torch

from tnbench import harness


# an altered answer is off by this many times the cell's limit
MARGIN = 10.0


def _unchanged_step(orig, alter):
    """A pair step that hands back its first operand unchanged where the
    shapes allow it."""
    def apply_pairwise(x, y, *args, **kwargs):
        out = orig(x, y, *args, **kwargs)
        return x if x.shape == out.shape else out
    return apply_pairwise


def _altered_slice(orig, alter):
    """The contractor's result for the first slice of each call scaled
    by ``alter`` where it is produced."""
    def factory(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def altered(planes, ids, *rest, **kw):
            res = fn(planes, ids, *rest, **kw).clone()
            res[0] *= alter
            return res
        _keep_attrs(fn, altered)
        return altered
    return factory


def _altered_value(orig, alter):
    def contract_slice(*args, **kwargs):
        return orig(*args, **kwargs) * alter
    return contract_slice


def _altered_bmm(orig, alter):
    def pairwise(*args, **kwargs):
        out, amax = orig(*args, **kwargs)
        return out * alter, amax
    return pairwise


def _half_batch(orig, alter):
    """The contractor's per-slice results: the first half kept, each
    slice replaced by their mean (the batch summed as S x the mean)."""
    def factory(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def half(planes, ids, *rest, **kw):
            res = fn(planes, ids, *rest, **kw)
            h = max(1, res.shape[0] // 2)
            return res[:h].mean(0, keepdim=True).expand_as(res).contiguous()
        _keep_attrs(fn, half)
        return half
    return factory


def _keep_attrs(fn, wrapper):
    for attr in ("mode", "batch", "digits", "fold", "plans"):
        if hasattr(fn, attr):
            setattr(wrapper, attr, getattr(fn, attr))


# where each fault is planted: (module, name, wrapper) of each route
FAULTS = {
    "step_unchanged": [
        ("cotengra_tpu_torch.ops.grouped", "apply_pairwise", _unchanged_step),
        ("cotengra_tpu_torch.ops.executor", "apply_pairwise", _unchanged_step),
    ],
    "slice_answer_altered": [("cotengra_tpu_torch", "make_grouped_contractor", _altered_slice)],
    "task_answer_altered": [("cotengra_tpu_torch", "contract_slice", _altered_value)],
    "bmm_answer_altered": [
        ("cotengra_tpu_torch.ops.executor", "pairwise_bmm_absmax", _altered_bmm),
    ],
    "half_batch_mean": [("cotengra_tpu_torch", "make_grouped_contractor", _half_batch)],
}
CASES = [
    ("m20-slices", "step_unchanged"),
    ("m20-slices", "slice_answer_altered"),
    ("m20-slices", "half_batch_mean"),
    ("m20-slice-tasks", "step_unchanged"),
    ("m20-slice-tasks", "task_answer_altered"),
    ("lattice-values", "bmm_answer_altered"),
]


@pytest.mark.parametrize("cell", ["m20-slices", "m20-slice-tasks", "lattice-values"])
def test_sound_program_is_correct(tiny_root, cell):
    res = harness.run_cell(tiny_root, cell, 2**31 + 99, 0.3, False, "cpu")
    assert res["correct"] and res["failed"] == 0, res["check"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(tiny_root, cell, fault, monkeypatch):
    import importlib

    limit = float(harness.check_spec(harness.resolve_cell(tiny_root, cell))["limit"])
    alter = 1.0 + MARGIN * limit
    for mod_name, attr, make in FAULTS[fault]:
        mod = importlib.import_module(mod_name)
        monkeypatch.setattr(mod, attr, make(getattr(mod, attr), alter))
    if cell == "lattice-values":
        # the tiny lattice's steps take the kernel's route on the CPU too
        monkeypatch.setattr(
            "cotengra_tpu_torch.ops.executor._pallas_step_ok", lambda *a: True, raising=True
        )
    res = harness.run_cell(tiny_root, cell, 2**31 + 7, 0.3, False, "cpu")
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["m20-slices", "lattice-values"])
def test_control_reads_above_the_program(tiny_root, cell):
    """The control (the reference in TF32, in the program's place) on the
    same calls reads far above the sound program, even at the tiny size."""
    spans = harness.Spans()
    c = harness.resolve_cell(tiny_root, cell)
    dev = torch.device("cpu")
    session, sets, inputs, output, size_dict, k = harness.setup(c, 3, dev, spans)
    calls, _, _ = harness.window(session, k, 0.2, spans)
    harness.free_program(session)
    worst, n = harness.judge(c, session, calls, sets, inputs, output, size_dict, dev, 3,
                             [c.config["control"]])
    assert n >= 1 and worst[0] > 10 * worst["program"]
