"""The numbers that decide ``correct``, one module per name that a
configuration's ``"check"`` gives. Each has ``number(got, ref, norm)``
on ``(mantissa, log10 exponent)`` values: the program's (or the
control's) result, the reference's, and the reference's norm of the
call's slices (the root of the sum of their squared magnitudes), the
last two in the same exponent."""
