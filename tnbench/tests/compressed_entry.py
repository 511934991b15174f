"""A compressed (chi-truncated) contraction per call.

An entry as a change that adds a compressed cell adds it, as
``tnbench/entries/compressed.py``: ``test_tnbench_resolve.py`` copies it
there in a copy of the benchmark, beside a configuration and a traffic
mix, and runs the cell without editing any file the copy had.

``entry``: ``{"kind": "compressed", "options": {...}}``. The program's
``ContractionTreeCompressed.contract_compressed(arrays, device=...,
**options)`` on the configuration's plan, whose surface order is the
order of its ``children``. Set-up puts every input set on the card;
call ``k`` contracts set ``k`` modulo the traffic's ``input_sets``.
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
