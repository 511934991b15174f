"""Host ms per profiled call in the program's ``compressed.truncate``
spans, less their children: each truncated bond's QR, SVD and products
and the host's waits for their results (``program_spans.self_ms``).
None where the program opens no such span."""

from tnbench.program_spans import self_ms


def read(run):
    return self_ms(run, ("compressed.truncate",))
