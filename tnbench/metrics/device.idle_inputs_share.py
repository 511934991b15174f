"""The share of the device's idle time in the profiled calls during
which the host's innermost program span selects slices or uploads
inputs (``program_spans.idle_share``); its splits ``.tasks`` and
``.values`` read the same."""

from tnbench.program_spans import INPUT_SPANS, idle_share


def read(run):
    return idle_share(run, INPUT_SPANS)
