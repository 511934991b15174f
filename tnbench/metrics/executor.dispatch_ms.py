"""Host milliseconds per call until the entry returns
(``readers.dispatch_ms``); its splits ``.tasks`` and ``.values`` read
the same."""

from tnbench.readers import dispatch_ms as read  # noqa: F401
