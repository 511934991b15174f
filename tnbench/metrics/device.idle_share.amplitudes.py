"""The device's idle share of the profiled calls that replay captured
graphs (``replays.idle_share``): ``device.idle_share``'s quantity, over
calls found whole by their own device records and by counting the
kernels that their replays ran, which no wrapper counts
(``tnbench/replays.py``). Under the profiler a graph's launch is slowed
many times over (``capture.replay_ms``), and the device waits for it:
that wait is in the share. None where the program records no
``capture.replay`` span."""

from tnbench.replays import idle_share as read  # noqa: F401
