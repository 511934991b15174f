"""Multi-contraction trees (counterpart of ``cotengra_tpu/tree_multi.py``):
one network contracted for a batch of index configurations (many
amplitudes of one circuit, say), sharing the intermediates that do not
depend on them.

Certain 'variable' indices take a different (projected) value per
configuration. They are kept in ``sliced_inds`` with the value ``None``,
so that every leg computation leaves them out. Every node's cost is
multiplied by the expected number of distinct configurations of the
variable indices it depends on, and the peak memory is estimated cache
aware: a node whose variable indices differ from a child's is 'bright',
and that child's results must be cached across configurations.
``exact_multi_stats`` counts an explicit batch exactly.
"""

import math

from .scoring import get_multi_objective
from .tree import ContractionTree, node_get_single_el


class ContractionTreeMulti(ContractionTree):
    def __init__(
        self,
        inputs,
        output,
        size_dict,
        varmults=None,
        numconfigs=None,
        objective=None,
        sliced_inds=(),
    ):
        if objective is None:
            objective = get_multi_objective(
                "uniform", numconfigs if numconfigs is not None else 1
            )
        super().__init__(inputs, output, size_dict, objective="flops")
        self._objective = objective
        # variable indices are stored in sliced_inds (value None) so that
        # all leg computations automatically exclude them
        self.sliced_inds = {ix: None for ix in sliced_inds}
        self._var_inds_cache = {}
        self._mult_cache = {}
        self._bright_cache = {}

    def set_default_objective(self, objective):
        self._objective = objective

    def copy(self):
        new = super().copy()
        new._var_inds_cache = dict(self._var_inds_cache)
        new._mult_cache = dict(self._mult_cache)
        new._bright_cache = dict(self._bright_cache)
        return new

    def _forget(self, node):
        super()._forget(node)
        self._var_inds_cache.pop(node, None)
        self._mult_cache.pop(node, None)
        self._bright_cache.pop(node, None)

    # -- variable-index bookkeeping ------------------------------------------

    def get_node_var_inds(self, node):
        """The variable indices this node's subtree depends on."""
        try:
            return self._var_inds_cache[node]
        except KeyError:
            pass
        if node.bit_count() == 1:
            i = node_get_single_el(node)
            out = {
                ix: None
                for ix in self.inputs[i]
                if ix in self.sliced_inds
            }
        else:
            try:
                l, r = self.children[node]
                out = {
                    **self.get_node_var_inds(l),
                    **self.get_node_var_inds(r),
                }
            except KeyError:
                out = {
                    ix: None
                    for i in range(self.N)
                    if (node >> i) & 1
                    for ix in self.inputs[i]
                    if ix in self.sliced_inds
                }
        self._var_inds_cache[node] = out
        return out

    def get_node_is_bright(self, node):
        """A node is 'bright' if its variable indices differ from a
        child's - then child results must be cached across configs."""
        try:
            return self._bright_cache[node]
        except KeyError:
            pass
        if node.bit_count() == 1:
            i = node_get_single_el(node)
            out = any(ix in self.sliced_inds for ix in self.inputs[i])
        else:
            l, r = self.children[node]
            nv = self.get_node_var_inds(node)
            out = (nv != self.get_node_var_inds(l)) or (
                nv != self.get_node_var_inds(r)
            )
        self._bright_cache[node] = out
        return out

    def get_node_mult(self, node):
        """Expected number of recomputations of this node across
        configurations."""
        try:
            return self._mult_cache[node]
        except KeyError:
            pass
        out = self._objective.estimate_node_mult(self, node)
        self._mult_cache[node] = out
        return out

    def get_node_cache_mult(self, node, sliced_ind_ordering):
        return self._objective.estimate_node_cache_mult(
            self, node, sliced_ind_ordering
        )

    # -- cost overrides -------------------------------------------------------

    def get_flops(self, node):
        return super().get_flops(node) * self.get_node_mult(node)

    def _ordered_cache_cost(self, first, second):
        """Cache pressure at a pair node when ``first``'s subtree is
        contracted before ``second``'s: a bright first child sits in the
        cache as a single copy while the whole second subtree runs, and a
        bright second child contributes one copy per recomputation.
        """
        cost = 0
        if self.get_node_is_bright(first):
            cost += self.get_size(first)
        if self.get_node_is_bright(second):
            cost += self.get_size(second) * self.get_node_mult(second)
        return cost

    def get_cache_contrib(self, node):
        """Estimated cache contribution of ``node``, orienting its
        children (in place) to whichever evaluation order is cheaper.
        """
        l, r = self.children[node]
        keep = self._ordered_cache_cost(l, r)
        swap = self._ordered_cache_cost(r, l)
        if swap < keep:
            self.children[node] = (r, l)
            return swap
        return keep

    def peak_size(self, order=None, log=None):
        peak = sum(
            self.get_cache_contrib(p) for p in self.children
        )
        if log is not None:
            peak = math.log(max(peak, 1), log)
        return peak

    def reorder_contractions_for_peak_est(self):
        """Orient children to minimize the cache-aware peak estimate."""
        swapped = False
        for p in list(self.children):
            l, r = self.children[p]
            before = (l, r)
            self.get_cache_contrib(p)
            if self.children[p] != before:
                swapped = True
        return swapped

    def reorder_sliced_inds(self):
        """Order the variable indices by first use in the contraction."""
        ordering = {}
        for node, _, _ in self.traverse():
            ordering.update(self.get_node_var_inds(node))
        self.sliced_inds = {ix: None for ix in ordering}

    # -- exact accounting over an explicit config batch -----------------------

    def exact_multi_stats(self, configs):
        """Exactly account for contracting ``configs`` (a list of
        ``{var_ind: value}`` dicts) with memoization of shared
        intermediates: flops are charged once per *distinct*
        (node, projected sub-config) value, and memory is simulated by
        freeing every cached value at its globally last read.

        A batch that repeats a configuration recomputes nothing for the
        repeat and frees nothing for it, so the stats do not change
        when configurations repeat.
        """
        order = tuple(self.traverse())

        # A *value* is (node_bitmask, tuple-of-variable-assignments):
        # the unit of memoization across configurations.
        def vkey(node, config):
            return node, tuple(
                config[ix] for ix in self.get_node_var_inds(node)
            )

        # Schedule one compute event per fresh value, in execution
        # order; record where each config's block of events ends.
        events = []  # (parent node, left vkey, right vkey)
        block_ends = []
        produced = set()
        for config in configs:
            for p, l, r in order:
                pk = vkey(p, config)
                if pk in produced:
                    continue
                produced.add(pk)
                events.append((p, vkey(l, config), vkey(r, config)))
            block_ends.append(len(events))
        del produced

        # Single backward sweep: last event index that reads each value.
        last_read = {}
        for t in range(len(events) - 1, -1, -1):
            _, lk, rk = events[t]
            last_read.setdefault(lk, t)
            last_read.setdefault(rk, t)

        # Forward memory simulation with free-at-last-read.  Leaf values
        # are the caller's input tensors (never freed); each config's
        # root amplitude is streamed out at its block boundary.  A block
        # is empty iff its exact config already appeared, in which case
        # nothing was recomputed and nothing new needs freeing.
        flops = 0
        live = peak = written = 0
        bi = 0
        for t, (p, lk, rk) in enumerate(events):
            flops += ContractionTree.get_flops(self, p)
            psize = self.get_size(p)
            live += psize
            written += psize
            if live > peak:
                peak = live
            for ck in (lk, rk):
                if last_read[ck] == t and ck[0].bit_count() > 1:
                    live -= self.get_size(ck[0])
            if bi < len(block_ends) and block_ends[bi] == t + 1:
                # traverse() ends at the root, so a non-empty block's
                # final event computed this config's root amplitude
                live -= psize
                # duplicate configs yield empty blocks sharing this
                # boundary: their root was already freed, skip them
                while bi < len(block_ends) and block_ends[bi] == t + 1:
                    bi += 1

        return {
            "flops": flops,
            "write": written,
            "size": self.max_size(),
            "peak": peak,
        }
