"""A run without a card, or without the program, fails and prints no
result."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "tnbench/run.py", "--workload", "m20-slices", "--seed", "5",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=str(cwd), capture_output=True, text=True, timeout=300,
    )


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "metrics" in obj), line


def test_no_card_no_result(cuda_absent):
    out = _run(ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    _no_result(out)


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(ROOT / "tnbench", tmp_path / "tnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, "tnbench/run.py", "--workload", "nope", "--seed", "1",
         "--seconds", "1"], cwd=str(ROOT), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    _no_result(out)
