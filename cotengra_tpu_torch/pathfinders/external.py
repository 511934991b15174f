"""External tree-decomposition solvers driven over subprocess: FlowCutter
(PACE-2017) and QuickBB (counterpart of
``cotengra_tpu/pathfinders/external.py``). Optional: the binaries are
looked up on ``PATH`` when a path is asked for, not at import.

The protocol: write the line graph in the solver's format, run with a
deadline (SIGTERM then parse partial output - both are anytime solvers),
auto-retry with 1.5x the time on empty output, convert the resulting
elimination order into an edge path.
"""

import shutil
import subprocess
import tempfile

from ..tree import ContractionTree
from .base import PathOptimizer
from .linegraph import (
    LineGraph,
    elimination_order_to_edge_path,
    td_str_to_elimination_order,
)

FLOWCUTTER_BINARIES = ("flow_cutter_pace17", "flow_cutter")
QUICKBB_BINARIES = ("quickbb_64", "quickbb")


def _find_binary(candidates):
    for name in candidates:
        path = shutil.which(name)
        if path:
            return path
    return None


def flowcutter_available():
    return _find_binary(FLOWCUTTER_BINARIES) is not None


def quickbb_available():
    return _find_binary(QUICKBB_BINARIES) is not None


def run_flowcutter(gr_text, max_time=10.0, executable=None):
    """Run flowcutter on a .gr graph, returning the .td output text."""
    exe = executable or _find_binary(FLOWCUTTER_BINARIES)
    if exe is None:
        raise RuntimeError("flow_cutter binary not found on PATH.")
    t = max_time
    for _attempt in range(3):
        proc = subprocess.Popen(
            [exe],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        try:
            out, _ = proc.communicate(input=gr_text, timeout=t)
        except subprocess.TimeoutExpired:
            proc.terminate()  # SIGTERM - flowcutter prints best-so-far
            try:
                out, _ = proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
        if out and "b " in out:
            return out
        t *= 1.5  # empty output: retry with more time
    raise RuntimeError("flowcutter produced no tree decomposition.")


def run_quickbb(cnf_text, max_time=10.0, executable=None):
    """Run quickbb on a CNF graph file, returning its stdout."""
    exe = executable or _find_binary(QUICKBB_BINARIES)
    if exe is None:
        raise RuntimeError("quickbb binary not found on PATH.")
    with tempfile.NamedTemporaryFile(
        "w", suffix=".cnf", delete=False
    ) as f:
        f.write(cnf_text)
        fname = f.name
    cmd = [
        exe,
        "--min-fill-ordering",
        "--time",
        str(int(max_time)),
        "--cnffile",
        fname,
    ]
    proc = subprocess.run(
        cmd,
        capture_output=True,
        text=True,
        timeout=max_time + 30,
    )
    return proc.stdout


def _parse_quickbb_order(text):
    for line in text.splitlines():
        if "elimination order" in line.lower():
            _, _, rest = line.partition(":")
            return [int(v) - 1 for v in rest.split()]
    # some versions print the order on the final line of ints
    for line in reversed(text.splitlines()):
        toks = line.split()
        if toks and all(t.lstrip("-").isdigit() for t in toks):
            return [int(v) - 1 for v in toks]
    raise RuntimeError("couldn't parse quickbb elimination order")


def optimize_flowcutter(
    inputs, output, size_dict, max_time=10.0, use_ssa=False
):
    """FlowCutter tree-decomposition pathfinder (needs the binary)."""
    lg = LineGraph(inputs, output)
    td = run_flowcutter(lg.to_gr_str(), max_time=max_time)
    order = td_str_to_elimination_order(td)
    edge_path = elimination_order_to_edge_path(order, lg, output)
    tree = ContractionTree.from_path(
        inputs, output, size_dict, edge_path=edge_path
    )
    return tree.get_ssa_path() if use_ssa else tree.get_path()


def optimize_quickbb(
    inputs, output, size_dict, max_time=10.0, use_ssa=False
):
    """QuickBB branch-and-bound treewidth pathfinder (needs the binary)."""
    lg = LineGraph(inputs, output)
    out = run_quickbb(lg.to_cnf_str(), max_time=max_time)
    order = _parse_quickbb_order(out)
    edge_path = elimination_order_to_edge_path(order, lg, output)
    tree = ContractionTree.from_path(
        inputs, output, size_dict, edge_path=edge_path
    )
    return tree.get_ssa_path() if use_ssa else tree.get_path()


class FlowCutterOptimizer(PathOptimizer):
    def __init__(self, max_time=10.0):
        self.max_time = max_time

    def ssa_path(self, inputs, output, size_dict):
        return optimize_flowcutter(
            inputs, output, size_dict, max_time=self.max_time,
            use_ssa=True,
        )


class QuickBBOptimizer(PathOptimizer):
    def __init__(self, max_time=10.0):
        self.max_time = max_time

    def ssa_path(self, inputs, output, size_dict):
        return optimize_quickbb(
            inputs, output, size_dict, max_time=self.max_time,
            use_ssa=True,
        )


def register_external_presets():
    """Register the external-binary presets unconditionally, as the JAX
    package does: using one without its binary on ``PATH`` fails at
    search time with the error naming the missing executable."""
    from ..interface import register_preset

    for t in (2, 10, 60):
        register_preset(f"flowcutter-{t}", FlowCutterOptimizer(max_time=t))
        register_preset(f"quickbb-{t}", QuickBBOptimizer(max_time=t))
