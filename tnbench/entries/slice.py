"""One slice per call, as a task pool hands them out.

``entry``: ``{"kind": "slice", "function": <an entry of the program
taking (tree, arrays, i, device=..., **options)>, "options": {...}}``.
Set-up puts the raw inputs on the card once (complex tensors, as a
worker holds them); call ``k`` contracts slice ``start + k``, the start
drawn from the seed (modulo the plan's slice count). Set-up builds the
one-slice contractor that the program keeps on the tree
(``tree.get_contractor``).
"""

from . import options, pull, start_id


class Slice:
    def __init__(self, ctx):
        entry = ctx.traffic["entry"]
        self.tree = ctx.tree
        self.fn = getattr(ctx.ctt, entry["function"])
        self.opts = options(ctx)
        self.device = ctx.device
        with ctx.spans.span("setup.upload"):
            self.arrays = ctx.ctt.to_tensors(
                ctx.sets[0], ctx.device, self.opts.get("plane_dtype")
            )
        with ctx.spans.span("setup.plan"):
            self.tree.get_contractor(self.device, **self.opts)
        self.start = start_id(ctx, 1)
        self.mode = None

    def slice_id(self, k):
        return (self.start + k) % self.tree.multiplicity

    def call(self, k):
        return self.fn(self.tree, self.arrays, self.slice_id(k), device=self.device, **self.opts)

    value = staticmethod(pull)

    def describe(self, k):
        return [self.slice_id(k)], 0

    def counters(self):
        return {"slices_per_call": 1}

    def release(self):
        self.arrays = None
        self.tree.contraction_cores.clear()


def prepare(ctx):
    return Slice(ctx)
