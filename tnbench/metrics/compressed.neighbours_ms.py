"""Host ms per profiled call in the program's ``compressed.neighbours``
spans, less the truncations inside them: the neighbour and index-holder
bookkeeping over the live tensors after each contraction
(``program_spans.self_ms``). None where the program opens no such
span."""

from tnbench.program_spans import self_ms


def read(run):
    return self_ms(run, ("compressed.neighbours",))
