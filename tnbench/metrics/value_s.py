"""Seconds per value of a lattice cell, every slice summed
(``readers.seconds_per_call``)."""

from tnbench.readers import seconds_per_call as read  # noqa: F401
