"""A compressed (chi-truncated) contraction per call.

``entry``: ``{"kind": "compressed_tree", "options": {...}}``. The
program's ``ContractionTreeCompressed.contract_compressed(arrays,
device=..., **options)`` on the configuration's plan, whose surface
order is the order of its ``children``. Set-up puts every input set on
the card; call ``k`` contracts set ``k`` modulo the traffic's
``input_sets``.

The same entry as ``tnbench/tests/compressed_entry.py``, which
``test_tnbench_resolve.py`` copies into a copy of the benchmark as
``entries/compressed.py`` to show that such a cell is added with files
alone.
"""

import torch

from . import options, pull


class Compressed:
    def __init__(self, ctx):
        t = ctx.tree
        with ctx.spans.span("setup.plan"):
            self.tree = ctx.ctt.ContractionTreeCompressed(
                t.inputs, t.output, t.size_dict, children=t.children
            )
        self.opts = options(ctx)
        self.device = ctx.device
        with ctx.spans.span("setup.upload"):
            self.sets = [[torch.as_tensor(a, device=ctx.device) for a in s] for s in ctx.sets]
        self.n_sets = len(self.sets)
        self.mode = None

    def call(self, k):
        return self.tree.contract_compressed(
            self.sets[k % self.n_sets], device=self.device, **self.opts
        )

    value = staticmethod(pull)

    def describe(self, k):
        return [0], k % self.n_sets

    def counters(self):
        return {"slices_per_call": 1}

    def release(self):
        self.sets = None


def prepare(ctx):
    return Compressed(ctx)
