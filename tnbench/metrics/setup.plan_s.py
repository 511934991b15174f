"""Seconds in the benchmark's ``setup.plan`` spans: the committed plan
loaded into the program's tree (``load_tree``) and, where the entry has
a way to build it before its first call, the program's contractor (a
factory, or ``tree.get_contractor``); otherwise the first warm-up call
builds it, in ``setup.warm_s``."""


def read(run):
    return run.spans.total("setup.plan")
