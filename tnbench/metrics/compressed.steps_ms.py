"""Host ms per profiled call in the program's ``compressed.step`` spans,
less the neighbour passes inside them: each step's leg bookkeeping, its
pairwise contraction and its stripping (``program_spans.self_ms``). None
where the program opens no such span."""

from tnbench.program_spans import self_ms


def read(run):
    return self_ms(run, ("compressed.step",))
