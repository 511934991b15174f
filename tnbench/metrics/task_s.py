"""Seconds per task of a one-slice-per-call cell
(``readers.seconds_per_call``)."""

from tnbench.readers import seconds_per_call as read  # noqa: F401
