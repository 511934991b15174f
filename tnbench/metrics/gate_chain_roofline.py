"""The gate-chain kernel's least time (``roofline.chain_bound_s`` on the
shapes recorded at ``run_chain_cuda``) over its profiled device time,
summed over the whole profiled calls, in percent; its split ``.tasks``
reads the same."""

from tnbench.roofline import roofline


def read(run):
    if run.profile is None:
        return None
    share = roofline(run.profile, "gate_chain")
    return None if share is None else 100.0 * share
