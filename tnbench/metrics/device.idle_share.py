"""The device's idle share of the whole profiled calls
(``readers.idle_share``); its splits ``.tasks`` and ``.values`` read
the same."""

from tnbench.readers import idle_share as read  # noqa: F401
