"""A batched contractor called on consecutive slice ids.

``entry``: ``{"kind": "slice_batches", "factory": <a contractor factory
of the program taking (tree, device, **options) and returning
fn(planes, slice_ids)>, "slices_per_call": B, "options": {...}}``.
Set-up uploads the raw inputs once as split-complex planes; call ``k``
runs ``fn(planes, ids)`` on the ``k``-th run of ``B`` ids after a start
drawn from the seed (ids modulo the plan's slice count), and sums the
per-slice results on the card. A plan of 2^29 slices never repeats an
id within a run.
"""

from . import options, pull, start_id, sum_batch


class SliceBatches:
    def __init__(self, ctx):
        entry = ctx.traffic["entry"]
        self.tree = ctx.tree
        self.per_call = int(entry["slices_per_call"])
        opts = options(ctx)
        with ctx.spans.span("setup.upload"):
            self.planes = ctx.ctt.to_plane_tensors(
                ctx.sets[0], ctx.device, opts.get("plane_dtype")
            )
        with ctx.spans.span("setup.plan"):
            self.fn = getattr(ctx.ctt, entry["factory"])(ctx.tree, ctx.device, **opts)
        self.start = start_id(ctx, self.per_call)
        self.mode = getattr(self.fn, "mode", None)

    def ids(self, k):
        first = self.start + k * self.per_call
        n = self.tree.multiplicity
        return [(first + j) % n for j in range(self.per_call)]

    def call(self, k):
        return sum_batch(self.fn(self.planes, self.ids(k)))

    value = staticmethod(pull)

    def describe(self, k):
        return self.ids(k), 0

    def counters(self):
        return {"slices_per_call": self.per_call}

    def release(self):
        self.fn = self.planes = None
        self.tree.contraction_cores.clear()


def prepare(ctx):
    return SliceBatches(ctx)
