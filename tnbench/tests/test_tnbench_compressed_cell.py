"""The compressed lattice's cell, ``compressed16x16-chi32``: it resolves
from ``BENCHMARK.json`` to its files; its plan is the one that
``chip_smoke.py`` phase 16 plans and its first input set phase 16's
input; a 4x4 copy of its configuration at chi=8 runs correct on the CPU
through the real entry and generator; the readers of its per-layer
metrics read a recorded call, and nothing where the program opens no
compressed span. On the card, at full size, the float32 control fails
the configuration's limit where the program passes it."""

import json
import time

import numpy as np
import pytest

import chip_smoke
from conftest import ROOT, compressed_plan, make_tiny

CELL = "compressed16x16-chi32"
CONFIG = "lattice16x16-d4-chi32"
COMPRESSED_METRICS = ("compressed.truncate_ms", "compressed.neighbours_ms",
                      "compressed.steps_ms")
CONTROL_SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _config():
    return json.loads((ROOT / "tnbench" / "configs" / f"{CONFIG}.json").read_text())


def test_cell_resolves_to_its_files():
    from tnbench import harness

    cell = harness.resolve_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.config["name"] == CONFIG
    assert cell.traffic["entry"]["kind"] == "compressed_tree"
    assert harness.plugin("entries", "compressed_tree").prepare
    assert {m["name"] for m in cell.end_to_end} == {"call_s", "peak_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names >= {"executor.dispatch_ms.compressed", "device.idle_share.compressed",
                     *COMPRESSED_METRICS}
    assert {m["layer"] for m in cell.per_layer if m["name"] in COMPRESSED_METRICS} == {
        "compressed contraction"}
    assert harness.program_options(cell) == {"chi": 32, "compress_late": False,
                                             "strip_exponent": True}
    assert cell.config["reference"]["kind"] == "compressed"


def test_plan_and_first_input_are_phase_16s():
    """The plan file walks the port's chi=32 greedy compressed plan in
    its surface order, left and right alike, and the planner's SSA path
    is phase 16's (its hash); the generator's set 0 of seed 0 is phase
    16's input array for array."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.pathfinders.compressed import greedy_compressed_ssa
    from tnbench import harness
    from tnbench.networks import lattice_normal
    from tnbench.reference import compressed

    conf = _config()
    inputs, output, size_dict, (arrays,) = lattice_normal.make_sets(conf["network"], 0, 1)
    ssa = greedy_compressed_ssa(inputs, output, size_dict, chi=32)
    assert chip_smoke._path_hash(ssa) == chip_smoke.COMPRESSED_PATH_HASH
    planned = ctt.ContractionTreeCompressed.from_path(inputs, output, size_dict, ssa_path=ssa)
    loaded = harness._load_tree(ctt, conf, inputs, output, size_dict)
    tree = ctt.ContractionTreeCompressed(loaded.inputs, loaded.output, loaded.size_dict,
                                         children=loaded.children)
    order = list(planned.traverse("surface_order"))
    assert list(tree.traverse("surface_order")) == order
    ref = compressed.CompressedPlan(conf["plan"], inputs, output, size_dict, 32)
    assert ref.steps == order

    want_inputs, _, want_sizes, want = chip_smoke._compressed_inputs()
    assert [list(t) for t in inputs] == [list(t) for t in want_inputs]
    assert size_dict == want_sizes
    assert len(arrays) == len(want)
    for a, b in zip(arrays, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _tiny(root):
    """A copy of the benchmark at ``root`` whose compressed configuration
    is a 4x4 bond-4 lattice at chi=8, planned as the full one is."""
    from tnbench.networks import lattice_normal

    root = make_tiny(root)
    path = root / "tnbench" / "configs" / f"{CONFIG}.json"
    conf = json.loads(path.read_text())
    conf["network"]["dims"] = [4, 4]
    conf["options"]["chi"] = conf["reference"]["chi"] = 8
    inputs, output, size_dict, _ = lattice_normal.make_sets(conf["network"], 0, 1)
    conf["plan"], tree, _ = compressed_plan(inputs, output, size_dict, 8)
    assert tree.total_write(chi=8) < tree.total_write_exact()  # it truncates
    path.write_text(json.dumps(conf))
    return root


def test_tiny_copy_is_correct_on_the_cpu(tmp_path):
    from cotengra_tpu_torch.ops import compressed
    from tnbench import harness

    root = _tiny(tmp_path)
    before = dict(compressed.COUNTS)
    res = harness.run_cell(root, CELL, 2**31 + 5, 0.3, False, "cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res
    # peak_gib reads nothing on the CPU
    assert set(res["metrics"]) == {"setup_s", "call_s"}
    check = res["check"]["slice_norm_err"]
    assert check["calls"] == min(2, res["attempted"])
    assert check["value"] <= check["limit"] == _config()["check"]["limit"]
    assert compressed.COUNTS["truncations"] > before["truncations"]


def _recorded_run(root, monkeypatch):
    """One profiled call of the tiny cell on the CPU, its spans recorded
    (``tracing.record()``) and its device timeline a marker alone: the
    ``Run`` the readers read."""
    import torch

    from cotengra_tpu_torch import tracing
    from tnbench import harness, trace

    cell = harness.resolve_cell(root, CELL)
    monkeypatch.setattr(harness, "resolve_cell", lambda *a: cell)
    session = harness.setup(cell, 3, torch.device("cpu"), harness.Spans())[0]
    with tracing.record():
        t0 = time.perf_counter()
        res = session.call(0)
        t1 = time.perf_counter()
        session.value(res)
        t2 = time.perf_counter()
    info = {"host": (t0, t1, t2), "launches": {k: 0 for k in trace.WRAPPERS},
            "shapes": {k: [] for k in trace.WRAPPERS}}
    marker = {"name": trace.MARKER, "short": trace.MARKER, "t0": 0.0, "t1": 1e-6}
    profile = trace.cut_calls([marker], [info])
    call = harness.CallRecord(0, t0, t1, t2, True)
    return harness.Run(cell, 0.0, harness.Spans(), [call], t2 - t0, 0, profile), tracing


def test_readers_of_the_compressed_metrics(tmp_path, monkeypatch):
    from tnbench import harness

    root = _tiny(tmp_path)
    run, tracing = _recorded_run(root, monkeypatch)
    entry = [r for r in tracing.records() if r.name == "entry"]
    assert [r.attrs["kind"] for r in entry] == ["compressed"]
    values = {m: harness.metric_reader(root, m)(run) for m in COMPRESSED_METRICS}
    assert all(v is not None and v > 0 for v in values.values()), values
    entry_ms = (entry[0].end - entry[0].start) * 1e-6
    assert sum(values.values()) <= entry_ms
    dispatch = harness.metric_reader(root, "executor.dispatch_ms.compressed")(run)
    assert entry_ms <= dispatch
    # a program that opens no compressed span (nor an entry) reads None
    monkeypatch.setattr(tracing, "records", lambda: [])
    for m in COMPRESSED_METRICS:
        assert harness.metric_reader(root, m)(run) is None


@pytest.mark.cuda
def test_control_fails_where_the_program_passes_at_full_size(cuda):
    from tnbench import calibrate, harness

    limit = float(harness.check_spec(harness.resolve_cell(ROOT, CELL))["limit"])
    rows = calibrate.readings(ROOT, CELL, CONTROL_SEEDS, set(CONTROL_SEEDS), 2.0, "cuda")
    for r in rows:
        assert r["failed"] == 0 and r["program"] <= limit < r["control"], r
