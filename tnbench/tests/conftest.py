"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
tiny size (a 12-qubit circuit and a 4x4 lattice, planned and sliced by
the program's own planner), to drive whole runs on the CPU.

Run them with ``python -m pytest tnbench/tests -q -p no:cacheprovider``
from the root of the checkout (the repository's ``pytest tests/`` does
not collect them); the ``cuda`` tests run only where a card is.
"""

import io
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CIRCUIT = {"n_qubits": 12, "depth": 6}
TINY_LATTICE = {"dims": [4, 4], "d_min": 8}


def _plan(inputs, output, size_dict, target_slices):
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.io import save_tree

    path = ctt.array_contract_path(inputs, output, size_dict=size_dict, optimize="greedy")
    tree = ctt.ContractionTree.from_path(inputs, output, size_dict, path=path)
    tree.slice_(target_slices=target_slices)
    f = io.StringIO()
    save_tree(f, tree)
    return json.loads(f.getvalue())


def compressed_plan(inputs, output, size_dict, chi):
    """``(plan file as JSON, tree, its SSA path)`` from the program's
    greedy compressed planner: the file's ``children`` in surface
    order."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.pathfinders.compressed import greedy_compressed_ssa
    from cotengra_tpu_torch.utils.io import save_tree

    ssa = greedy_compressed_ssa(inputs, output, size_dict, chi=chi)
    tree = ctt.ContractionTreeCompressed.from_path(inputs, output, size_dict, ssa_path=ssa)
    f = io.StringIO()
    save_tree(f, tree)
    return json.loads(f.getvalue()), tree, ssa


def make_tiny(root):
    """A copy of ``BENCHMARK.json`` and ``tnbench/`` under ``root``
    whose configurations are tiny: the same generators, entries,
    metrics, checks and limits."""
    from tnbench.networks import lattice, sycamore_circuit

    root = Path(root)
    shutil.copytree(ROOT / "tnbench", root / "tnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, gen, size, slices in (
        ("sycamore-like-6x9-m20", sycamore_circuit, TINY_CIRCUIT, 64),
        ("lattice7x7-d16", lattice, TINY_LATTICE, 4),
    ):
        path = root / "tnbench" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf["network"].update(size)
        inputs, output, size_dict, _ = gen.make_sets(conf["network"], 0, 1)
        conf["plan"] = _plan(inputs, output, size_dict, slices)
        path.write_text(json.dumps(conf))
    traffic = root / "tnbench" / "traffic" / "slice-batches-11.json"
    t = json.loads(traffic.read_text())
    t["entry"]["slices_per_call"] = t["entry"]["options"]["slice_batch"] = 4
    traffic.write_text(json.dumps(t))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda():
    """Skip a test that needs the card where there is none (decided
    when the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def cuda_absent():
    """Skip a test of the card-less path where a card is present."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
