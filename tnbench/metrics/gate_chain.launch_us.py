"""Host us per gate-chain ``kernel.launch`` span (one a pass, the
wrapper's work up to and including the launch;
``program_spans.launch_us``); its split ``.tasks`` reads the same."""

from tnbench.program_spans import launch_us


def read(run):
    return launch_us(run, "gate_chain")
