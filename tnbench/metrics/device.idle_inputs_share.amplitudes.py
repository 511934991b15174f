"""The share of the device's idle time in the profiled calls that
replay captured graphs during which the host's innermost program span
selects slices or uploads inputs (``replays.idle_share_in``):
``device.idle_inputs_share``'s quantity, over the calls that
``replays`` finds whole, the clocks tied at each call's pull. None
where the program records no ``capture.replay`` span."""

from tnbench.program_spans import INPUT_SPANS
from tnbench.replays import idle_share_in


def read(run):
    return idle_share_in(run, INPUT_SPANS)
