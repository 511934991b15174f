"""Quantities that more than one metric file of ``metrics/`` reads
(``call_s``, ``task_s`` and ``value_s`` are one quantity under three
bounds). A per-layer quantity split by the end-to-end metric it moves
(``device.idle_share``, ``.tasks``, ``.values``) keeps one file, found
by ``harness.metric_path``."""


def seconds_per_call(run):
    """Window seconds over the calls completed in it (host clock): the
    window runs whole calls, each ending in a host pull checked finite,
    until the run's ``--seconds`` have passed."""
    done = run.completed
    if not done:
        return None
    return run.window_s / len(done)


def dispatch_ms(run):
    """Milliseconds from a window call's start until the program's
    entry returns, before the pull waits for the card: the host's work
    of a call (the mean over the window's calls). Where the entry
    waits for the card inside, the wait is in it too."""
    calls = run.calls
    if not calls:
        return None
    return 1e3 * sum(c.returned - c.start for c in calls) / len(calls)


def idle_share(run):
    """1 - (union of the device's records) / host wall, over the
    profiled calls whose records arrived whole (``trace.py``)."""
    if run.profile is None:
        return None
    calls = run.profile.whole()
    wall = sum(c["wall"] for c in calls)
    if wall <= 0.0:
        return None
    return 1.0 - sum(c["busy"] for c in calls) / wall
