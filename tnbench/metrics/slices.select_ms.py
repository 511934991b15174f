"""Host ms per call in the program's ``slices.select`` spans, less their
children (``program_spans.self_ms``); its splits ``.tasks`` and
``.values`` read the same."""

from tnbench.program_spans import self_ms


def read(run):
    return self_ms(run, ("slices.select",))
