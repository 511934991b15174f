"""Host us per ``bmm_absmax`` ``kernel.launch`` span (the wrapper's work
up to and including the launch; ``program_spans.launch_us``)."""

from tnbench.program_spans import launch_us


def read(run):
    return launch_us(run, "bmm_absmax")
