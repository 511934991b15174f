"""``bmm_absmax``'s least time (``roofline.bmm_bound_s`` on the shapes
recorded at ``bmm_absmax_cuda``) over the device time of every kernel
its launches run, summed over the whole profiled calls, in percent."""

from tnbench.roofline import roofline


def read(run):
    if run.profile is None:
        return None
    share = roofline(run.profile, "bmm_absmax")
    return None if share is None else 100.0 * share
