"""BENCHMARK.json against the contract, every cell resolved by name to
its files, and a configuration, traffic mix and metric added as new
files alone, in a copy, and found without editing any file."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, compressed_plan, make_tiny

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


def _files(root):
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts
    }


def test_compressed_cell_is_added_with_files_alone(tmp_path):
    """A compressed (chi-truncated) configuration, its entry and a traffic
    mix are added to a copy of the benchmark as new files, and entries in
    ``BENCHMARK.json``; a run of the new cell from the copy (set-up, a
    short window, the judgement against the compressed reference that
    the configuration names) is correct on the CPU, and no file that the
    copy had is edited."""
    from tnbench.networks import lattice

    root = make_tiny(tmp_path)
    before = _files(root)
    recipe = {"generator": "lattice", "dims": [4, 4], "d_min": 4, "low": -1.0, "high": 1.0,
              "dtype": "float64"}
    inputs, output, size_dict, _ = lattice.make_sets(recipe, 0, 1)
    plan, _, _ = compressed_plan(inputs, output, size_dict, 8)
    conf = {
        "name": "lattice4x4-d4-chi8", "network": recipe, "plan": plan,
        "options": {"chi": 8, "compress_late": False, "strip_exponent": True},
        "precision": "float64, each contraction's result renormalised by its |max|",
        "reference": {"kind": "compressed", "dtype": "float64", "strip": True, "chi": 8,
                      "compress_late": False},
        "control": {"dtype": "float32"},
        "check": {"number": "slice_norm_err", "limit": 1e-4},
        "reduced": [],
    }
    bench_dir = root / "tnbench"
    (bench_dir / "configs" / "lattice4x4-d4-chi8.json").write_text(json.dumps(conf))
    shutil.copy(ROOT / "tnbench" / "tests" / "compressed_entry.py",
                bench_dir / "entries" / "compressed.py")
    traffic = {"entry": {"kind": "compressed"}, "input_sets": 2, "warmup_calls": 1,
               "profile_calls": 1, "check_calls": 2}
    (bench_dir / "traffic" / "compressed-values-2.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(bench))
    bench["configs"].append({
        "name": "lattice4x4-d4-chi8", "source": "https://arxiv.org/abs/2206.07044",
        "file": "tnbench/configs/lattice4x4-d4-chi8.json", "reduced": [], "why": "test",
    })
    bench["workloads"].append({
        "name": "compressed-values", "config": "lattice4x4-d4-chi8",
        "traffic": "compressed-values-2", "chips": 1, "why": "test",
    })
    bench["end_to_end"].append({
        "name": "value_s.compressed", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock", "workloads": ["compressed-values"],
    })
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    repo_before = _files(ROOT / "tnbench")

    code = f"""
import json, sys
sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]
from tnbench import harness
assert harness.__file__.startswith({str(root)!r}), harness.__file__
print(json.dumps(harness.run_cell({str(root)!r}, "compressed-values", 2**31 + 5, 0.3, False,
                                  "cpu")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(root), env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res
    assert set(res["metrics"]) == {"setup_s", "value_s.compressed"}
    check = res["check"]["slice_norm_err"]
    assert check["calls"] == min(2, res["attempted"]) and check["value"] <= 2e-6, check

    after = _files(root)
    added = set(after) - set(before)
    assert added == {"tnbench/configs/lattice4x4-d4-chi8.json", "tnbench/entries/compressed.py",
                     "tnbench/traffic/compressed-values-2.json"}
    assert all(after[p] == b for p, b in before.items() if p != "BENCHMARK.json")
    new = json.loads(after["BENCHMARK.json"])
    for key, value in old.items():
        assert new[key][: len(value)] == value if isinstance(value, list) else new[key] == value
    assert _files(ROOT / "tnbench") == repo_before
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
