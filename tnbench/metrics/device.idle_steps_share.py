"""The share of the device's idle time in the profiled calls during
which the host's innermost program span is the step loop, a step or a
kernel's launch (``program_spans.idle_share``); its splits ``.tasks``
and ``.values`` read the same."""

from tnbench.program_spans import STEP_SPANS, idle_share


def read(run):
    return idle_share(run, STEP_SPANS)
