"""Seconds in the benchmark's ``setup.warm`` span: the warm-up calls
before the window, each ending in a host pull."""


def read(run):
    return run.spans.total("setup.warm")
