"""BENCHMARK.json against the contract, every cell resolved by name to
its files, and a configuration, traffic mix and metric added as new
files alone, in a copy, and found without editing any file."""

import json
import re
import shutil

import pytest

from conftest import ROOT, make_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer",
    }
    assert BENCH["paths"] == ["tnbench"]
    assert BENCH["command"] == ["python3", "tnbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    assert len({x["name"] for x in BENCH["workloads"]}) == len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("tnbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    from tnbench import harness

    c = harness.resolve_cell(ROOT, cell)
    harness.plugin("networks", c.config["network"]["generator"])
    harness.plugin("entries", c.traffic["entry"]["kind"])
    harness.plugin("checks", harness.check_spec(c)["number"])
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """A later change adds only files and entries: a configuration, a
    traffic mix and a metric, none of them known to the harness's code."""
    from tnbench import harness

    root = make_tiny(tmp_path)
    conf_dir = root / "tnbench" / "configs"
    lat = json.loads((conf_dir / "lattice7x7-d16.json").read_text())
    lat["options"]["implementation"] = None
    (conf_dir / "lattice-default.json").write_text(json.dumps(lat))
    traffic = {
        "entry": {"kind": "full", "function": "contract_tree"},
        "input_sets": 2, "warmup_calls": 1, "profile_calls": 1, "check_calls": 1,
    }
    (root / "tnbench" / "traffic" / "value-sets-2.json").write_text(json.dumps(traffic))
    (root / "tnbench" / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(len(run.completed))\n"
    )
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "lattice-default", "source": "https://example.org/x",
        "file": "tnbench/configs/lattice-default.json", "reduced": [], "why": "test",
    })
    bench["workloads"].append({
        "name": "lattice-default-values", "config": "lattice-default", "traffic": "value-sets-2",
        "chips": 1, "why": "test",
    })
    bench["end_to_end"].append({
        "name": "calls_done", "unit": "calls", "better": "higher", "bound": 0.25,
        "source": "host_clock", "workloads": ["lattice-default-values"],
    })
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "tnbench").rglob("*.py")}
    res = harness.run_cell(root, "lattice-default-values", 5, 0.3, False, "cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["calls_done"]["value"] == res["attempted"]
    # metrics without a "workloads" list apply to every cell, the new
    # one too (peak_gib reads nothing on the CPU)
    assert set(res["metrics"]) == {"setup_s", "calls_done"}
    assert before == {p: p.read_bytes() for p in (ROOT / "tnbench").rglob("*.py")}
    with pytest.raises(KeyError):
        harness.resolve_cell(root, "no-such-cell")
    shutil.rmtree(root)


def test_split_metrics_read_with_their_base_file():
    """A metric split only to move another end-to-end metric has no file
    of its own: it reads with the file of its name before the split."""
    from tnbench import harness

    metrics = ROOT / "tnbench" / "metrics"
    assert harness.metric_path(ROOT, "device.idle_share.values") == metrics / "device.idle_share.py"
    assert harness.metric_path(ROOT, "gate_chain_roofline.tasks") == metrics / "gate_chain_roofline.py"
    assert harness.metric_path(ROOT, "setup.plan_s") == metrics / "setup.plan_s.py"
    with pytest.raises(FileNotFoundError):
        harness.metric_path(ROOT, "no_such_metric.tasks")
