"""Host ms per call in the program's step loops, ``executor.steps`` and
``executor.step`` spans less their children (the kernels' launches
among them; ``program_spans.self_ms``); its splits ``.tasks`` and
``.values`` read the same."""

from tnbench.program_spans import self_ms


def read(run):
    return self_ms(run, ("executor.steps", "executor.step"))
