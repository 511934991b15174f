"""|got - ref| over the norm of the reference's slices of the call.

Each call's value is a sum over slices. Where the slices' values
cancel (a signed network, the random phases of circuit amplitudes), the
sum's own magnitude can be arbitrarily small against the slices it is
made of, and a relative error with it, for a sound program as for a
broken one. Floating point errs in proportion to the magnitudes it
adds, so the error is measured against the slices' norm, which does not
swing with the cancellation; for one slice per call it is the relative
error. Infinite where the program's exponent leaves float64's range."""

import math


def number(got, ref, norm):
    (gm, ge), (rm, re), (n, ne) = got, ref, norm
    if n == 0:
        return 0.0 if complex(gm) * 10.0 ** ge == complex(rm) * 10.0 ** re else math.inf
    try:
        g = complex(gm) * 10.0 ** (ge - re)
    except OverflowError:
        return math.inf
    return abs(g - complex(rm)) / n * 10.0 ** (re - ne)
