"""The gate-chain kernel's least time over its device time in the
profiled calls that replay captured graphs, in percent
(``replays.chain_roofline``): ``roofline.chain_bound_s`` over the chain
launches that the graphs' captures recorded, once per replay, where
``gate_chain_roofline`` reads the shapes at the wrapper, which a replay
never calls. None where the program records no ``capture.replay``
span."""

from tnbench.replays import chain_roofline


def read(run):
    share = chain_roofline(run)
    return None if share is None else 100.0 * share
