"""Host ms per profiled call in the program's ``inputs.upload`` spans,
less their children, over the calls that replay captured graphs and
whose records are intact (``replays.self_ms``): ``inputs.upload_ms``'s
quantity, read where ``program_spans`` finds no call whole (a replay's
kernels are counted by no wrapper). None where the program records no
``capture.replay`` span."""

from tnbench.replays import self_ms


def read(run):
    return self_ms(run, ("inputs.upload",))
