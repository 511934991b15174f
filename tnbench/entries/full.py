"""A whole contraction, every slice summed, per call.

``entry``: ``{"kind": "full", "function": <an entry of the program
taking (tree, arrays, device=..., **options)>, "options": {...}}``.
Call ``k`` takes the host (numpy) input set ``k`` modulo the traffic's
``input_sets``, so the upload is part of the call. The first warm-up
call builds the contractor that the program keeps on the tree.
"""

from . import options, pull


class Full:
    def __init__(self, ctx):
        entry = ctx.traffic["entry"]
        self.tree = ctx.tree
        self.fn = getattr(ctx.ctt, entry["function"])
        self.opts = options(ctx)
        self.device = ctx.device
        self.sets = ctx.sets
        self.n_sets = len(ctx.sets)
        self.mode = None

    def call(self, k):
        return self.fn(self.tree, self.sets[k % self.n_sets], device=self.device, **self.opts)

    value = staticmethod(pull)

    def describe(self, k):
        return list(range(self.tree.multiplicity)), k % self.n_sets

    def counters(self):
        return {"slices_per_call": self.tree.multiplicity}

    def release(self):
        self.tree.contraction_cores.clear()


def prepare(ctx):
    return Full(ctx)
