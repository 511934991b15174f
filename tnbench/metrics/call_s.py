"""Seconds per call of a slice-batch cell
(``readers.seconds_per_call``)."""

from tnbench.readers import seconds_per_call as read  # noqa: F401
