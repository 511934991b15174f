"""On the card, at the cells' own sizes: a short run of each cell is
correct, and the control, the plain reference in the precision below
the configuration's put in the program's place, fails the limit on
three seeds where the program passes it. Skipped without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROL_SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cuda, cell):
    out = subprocess.run(
        [sys.executable, "tnbench/run.py", "--workload", cell, "--seed", str(2**31 + 17),
         "--seconds", "3", "--trace", "0"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cuda, cell):
    from tnbench import calibrate, harness

    limit = float(harness.check_spec(harness.resolve_cell(ROOT, cell))["limit"])
    rows = calibrate.readings(ROOT, cell, CONTROL_SEEDS, set(CONTROL_SEEDS), 2.0, "cuda")
    for r in rows:
        assert r["failed"] == 0 and r["program"] <= limit < r["control"], r
