"""Objectives: the cost model of path finding and refinement
(counterpart of ``cotengra_tpu/scoring.py``).

Each exact objective supplies the hooks that the planner's subsystems
call - ``__call__(trial)`` (a trial's score, log2 scale),
``cost_local_tree_node``, ``score_local``, ``score_slice_index`` and
``get_dynamic_programming_minimize``. The compressed objectives score a
chi-capped contraction by replaying it on a ``HyperGraph``
(``replay_compressed_step``, ``CompressedStatsTracker``).

String specs parse like ``"flops"``, ``"size"``, ``"write"``,
``"combo"``/``"combo-64"``, ``"limit:32"``, ``"peak-compressed-16"``
(both ``-`` and ``:`` separators). The multi-contraction objectives
(``MultiObjective*``, ``get_multi_objective``) price a batch of index
configurations over one network (``tree_multi.py``). ``"gpu"`` /
``"gpu-<F>"`` score a tree by the grouped executor's modelled time on
the card (``GpuTimeObjective``, ``ops/simulate.py``); the reference's
``"tpu"`` model priced a TPU and raises here.
"""

import collections
import functools
import math
import re

DEFAULT_COMBO_FACTOR = 64


class Objective:
    __slots__ = ()

    def __call__(self, trial):
        raise NotImplementedError

    def __repr__(self):
        params = {k: getattr(self, k) for k in getattr(self, "__slots__", ())}
        return (
            f"{self.__class__.__name__}("
            + ", ".join(f"{k}={v}" for k, v in params.items())
            + ")"
        )

    def __hash__(self):
        return hash(repr(self))

    def __eq__(self, other):
        return repr(self) == repr(other)


def ensure_basic_quantities(trial):
    """Fill ``flops``, ``write``, ``size`` into a trial dict if missing."""
    if not all(q in trial for q in ("flops", "write", "size")):
        stats = trial["tree"].contract_stats()
        trial.setdefault("flops", stats["flops"])
        trial.setdefault("write", stats["write"])
        trial.setdefault("size", stats["size"])


class ExactObjective(Objective):
    __slots__ = ()

    def cost_local_tree_node(self, tree, node):
        raise NotImplementedError

    def score_local(self, **kwargs):
        raise NotImplementedError

    def score_slice_index(self, costs, ix):
        raise NotImplementedError

    def get_dynamic_programming_minimize(self):
        raise NotImplementedError


def _agg(x, combine=sum):
    try:
        return combine(x)
    except TypeError:
        return x


class FlopsObjective(ExactObjective):
    """Minimize total operation count, with tiny secondary weight on write
    and max-size to break ties.
    """

    __slots__ = ("secondary_weight",)

    def __init__(self, secondary_weight=1e-3):
        self.secondary_weight = secondary_weight

    def cost_local_tree_node(self, tree, node):
        return tree.get_flops(node)

    def score_local(self, **kwargs):
        return math.log2(_agg(kwargs["flops"]))

    def score_slice_index(self, costs, ix):
        return math.log(
            costs.flop_reductions[ix]
            + costs.write_reductions[ix] * self.secondary_weight
            + 1
        )

    def get_dynamic_programming_minimize(self):
        return "flops"

    def __call__(self, trial):
        ensure_basic_quantities(trial)
        return (
            math.log2(trial["flops"])
            + self.secondary_weight * math.log2(trial["write"])
            + self.secondary_weight * math.log2(trial["size"])
        )


class WriteObjective(ExactObjective):
    """Minimize total memory written (sum of all intermediate sizes)."""

    __slots__ = ("secondary_weight",)

    def __init__(self, secondary_weight=1e-3):
        self.secondary_weight = secondary_weight

    def cost_local_tree_node(self, tree, node):
        return tree.get_size(node)

    def score_local(self, **kwargs):
        return math.log2(_agg(kwargs["size"]))

    def score_slice_index(self, costs, ix):
        return math.log(
            costs.flop_reductions[ix] * self.secondary_weight
            + costs.write_reductions[ix]
            + 1
        )

    def get_dynamic_programming_minimize(self):
        return "write"

    def __call__(self, trial):
        ensure_basic_quantities(trial)
        return (
            self.secondary_weight * math.log2(trial["flops"])
            + math.log2(trial["write"])
            + self.secondary_weight * math.log2(trial["size"])
        )


class SizeObjective(ExactObjective):
    """Minimize the single largest intermediate tensor."""

    __slots__ = ("secondary_weight",)

    def __init__(self, secondary_weight=1e-3):
        self.secondary_weight = secondary_weight

    def cost_local_tree_node(self, tree, node):
        return tree.get_size(node)

    def score_local(self, **kwargs):
        return math.log2(_agg(kwargs["size"], combine=max))

    def score_slice_index(self, costs, ix):
        return math.log(
            costs.flop_reductions[ix] * self.secondary_weight
            + costs.write_reductions[ix]
            + 1
        )

    def get_dynamic_programming_minimize(self):
        return "size"

    def __call__(self, trial):
        ensure_basic_quantities(trial)
        return (
            self.secondary_weight * math.log2(trial["flops"])
            + self.secondary_weight * math.log2(trial["write"])
            + math.log2(trial["size"])
        )


class ComboObjective(ExactObjective):
    """Minimize ``log2(flops + factor * write)`` - a realistic single-number
    model of time on bandwidth-limited hardware. The default ``factor=64``
    approximates the flops:bytes ratio of modern accelerators.
    """

    __slots__ = ("factor",)

    def __init__(self, factor=DEFAULT_COMBO_FACTOR):
        self.factor = factor

    def cost_local_tree_node(self, tree, node):
        return tree.get_flops(node) + self.factor * tree.get_size(node)

    def score_local(self, **kwargs):
        f = _agg(kwargs["flops"])
        w = _agg(kwargs["size"])
        return math.log2(f + self.factor * w)

    def score_slice_index(self, costs, ix):
        return math.log(
            costs.flop_reductions[ix]
            + costs.write_reductions[ix] * self.factor
            + 1
        )

    def get_dynamic_programming_minimize(self):
        return f"combo-{self.factor}"

    def __call__(self, trial):
        ensure_basic_quantities(trial)
        return math.log2(trial["flops"] + self.factor * trial["write"])


class LimitObjective(ExactObjective):
    """Minimize ``sum_i max(flops_i, factor * write_i)`` - assumes each
    contraction is either compute- or bandwidth-bound.
    """

    __slots__ = ("factor",)

    def __init__(self, factor=DEFAULT_COMBO_FACTOR):
        self.factor = factor

    def cost_local_tree_node(self, tree, node):
        return max(tree.get_flops(node), self.factor * tree.get_size(node))

    def score_local(self, **kwargs):
        f = kwargs["flops"]
        w = kwargs["size"]
        try:
            return math.log2(
                sum(max(fi, self.factor * wi) for fi, wi in zip(f, w))
            )
        except TypeError:
            return math.log2(max(f, self.factor * w))

    def score_slice_index(self, costs, ix):
        return math.log(
            costs.flop_reductions[ix]
            + costs.write_reductions[ix] * self.factor
            + 1
        )

    def get_dynamic_programming_minimize(self):
        return f"limit-{self.factor}"

    def __call__(self, trial):
        tree = trial["tree"]
        return math.log2(tree.combo_cost(factor=self.factor, combine=max))


class GpuTimeObjective(ExactObjective):
    """Score trees by the grouped executor's modelled time on the card
    (counterpart of the reference's ``TpuTimeObjective``).

    A trial's score is the log2 of :func:`..ops.simulate.simulate_grouped`
    (the port's own step plan priced with ``H100_CONSTANTS``, or
    ``sim_constants`` over them). The cheap per-move hooks use the
    per-step roofline

        max(flops, flops_per_elem * (|out| + |lhs| + |rhs|))

    where ``flops_per_elem`` is the scalar work the card's true-fp32
    GEMMs retire while one stored element (``bytes_per_elem``: split
    complex float32, 8 B) streams: ``bytes_per_elem * gemm_tflops /
    dot_gbps`` of the constants.
    """

    __slots__ = ("bytes_per_elem", "flops_per_elem", "sim_constants")

    def __init__(self, bytes_per_elem=8, flops_per_elem=None,
                 sim_constants=None):
        from .ops.simulate import H100_CONSTANTS

        self.bytes_per_elem = bytes_per_elem
        if flops_per_elem is None:
            c = dict(H100_CONSTANTS, **(sim_constants or {}))
            flops_per_elem = (
                bytes_per_elem * c["gemm_tflops"] * 1e12
                / (c["dot_gbps"] * 1e9)
            )
        self.flops_per_elem = flops_per_elem
        self.sim_constants = sim_constants

    def _node_time(self, tree, node):
        traffic = tree.get_size(node)
        lr = tree.children.get(node)
        if lr is not None:
            traffic += tree.get_size(lr[0]) + tree.get_size(lr[1])
        return max(tree.get_flops(node), self.flops_per_elem * traffic)

    def cost_local_tree_node(self, tree, node):
        return self._node_time(tree, node)

    def score_local(self, **kwargs):
        # moves report (flops, output size) per step only: the operand
        # reads are taken as twice the output write, traffic 3 * |out|
        f = kwargs["flops"]
        s = kwargs["size"]
        try:
            total = sum(
                max(fi, 3 * self.flops_per_elem * si)
                for fi, si in zip(f, s)
            )
        except TypeError:
            total = max(f, 3 * self.flops_per_elem * s)
        return math.log2(total)

    def score_slice_index(self, costs, ix):
        return math.log(
            costs.flop_reductions[ix]
            + costs.write_reductions[ix] * self.flops_per_elem
            + 1
        )

    def get_dynamic_programming_minimize(self):
        # the nearest objective of the bitmask DP: per-step
        # max(flops, F * write)
        return f"limit-{int(self.flops_per_elem)}"

    def estimated_seconds(self, tree):
        """Modelled seconds of contracting ``tree`` once, all slices,
        slice by slice on the card (``simulate_grouped``)."""
        from .ops.simulate import simulate_grouped

        return simulate_grouped(tree, constants=self.sim_constants)

    def __call__(self, trial):
        tree = trial["tree"]
        ensure_basic_quantities(trial)
        return math.log2(max(self.estimated_seconds(tree), 1e-30))


# -- compressed contraction scoring ------------------------------------------
#
# A compressed (chi-capped, approximate) contraction's costs depend on the
# full history of bond truncations, so they are obtained by *replaying* the
# contraction on a HyperGraph interleaved with compress() calls. The
# replay is split into two pieces:
#
# 1. :func:`replay_compressed_step` - a measurement function that performs
#    one [compress]/contract/[compress] step on the hypergraph and returns
#    an immutable :class:`CompressedStep` record of what it cost;
# 2. :class:`CompressedStatsTracker` - a pure aggregate that ``absorb``s
#    step records into running totals (and can be re-based onto a different
#    history prefix, which windowed refinement needs).
#
# Keeping the per-step measurement out of the tracker means branch-and-bound
# searches can copy just the cheap aggregate state, and rebasing a suffix
# after a window rewrite is a one-record replay rather than a hook dance.

CompressedStep = collections.namedtuple(
    "CompressedStep",
    (
        "flops",  # operations spent this step (compressions + the pair dot)
        "out_size",  # size of the tensor the step produced
        "live_delta",  # net change of the total live footprint
        "high_water",  # max in-step footprint, relative to the pre-step total
    ),
)

_NULL_STEP = CompressedStep(0.0, 0.0, 0.0, 0.0)


def replay_compressed_step(hg, i, j, chi, compress_late, node=None):
    """Perform one compressed-contraction step on ``hg`` *in place* and
    measure it.

    The step order is the protocol every cost consumer in this package
    agrees on: if ``compress_late``, first chi-compress the bonds incident
    to ``i`` and ``j``; contract the pair; otherwise chi-compress the bonds
    of the new node afterwards. Compression changes neighbor tensors too,
    so footprint deltas are measured over whole neighborhoods.

    Returns ``(ij, step)`` - the new node id and a :class:`CompressedStep`.
    """
    flops = 0.0
    delta = 0.0

    if compress_late:
        pair = (i, j)
        flops += hg.neighborhood_compress_cost(chi, pair)
        delta -= hg.neighborhood_size(pair)
        hg.compress(chi=chi, edges=hg.get_node(i))
        hg.compress(chi=chi, edges=hg.get_node(j))
        delta += hg.neighborhood_size(pair)

    flops += hg.contract_pair_cost(i, j)
    delta -= hg.node_size(i) + hg.node_size(j)
    ij = hg.contract(i, j) if node is None else hg.contract(i, j, node=node)
    out_size = hg.node_size(ij)
    delta += out_size
    # all step inputs plus the fresh output coexist here, before any
    # early compression shrinks them: the footprint high-water mark
    high_water = delta

    if not compress_late:
        region = (ij,)
        flops += hg.neighborhood_compress_cost(chi, region)
        delta -= hg.neighborhood_size(region)
        hg.compress(chi=chi, edges=hg.get_node(ij))
        delta += hg.neighborhood_size(region)

    return ij, CompressedStep(flops, out_size, delta, high_water)


class CompressedStatsTracker:
    """Running totals (flops / write / max-size / peak-footprint) over a
    sequence of absorbed :class:`CompressedStep` records, seeded with the
    input tensors of ``hg``.
    """

    __slots__ = (
        "chi",
        "flops",
        "write",
        "max_size",
        "peak_size",
        "total_size",
        "last",
        "secondary_weight",
        "factor",
    )

    def __init__(self, hg, chi, secondary_weight=1e-3, factor=None):
        if chi == "auto":
            chi = max(hg.size_dict.values(), default=2) ** 2
        self.chi = chi
        self.secondary_weight = secondary_weight
        self.factor = factor

        sizes = [hg.node_size(i) for i in hg.nodes]
        self.total_size = sum(sizes)
        self.max_size = max(sizes, default=0)
        self.flops = 0
        # the inputs count as already-written memory and as the
        # starting peak footprint
        self.write = self.peak_size = self.total_size
        self.last = _NULL_STEP

    def copy(self):
        new = object.__new__(self.__class__)
        # walk the MRO: subclasses declare ``__slots__ = ()`` (or extra
        # fields) and ``self.__slots__`` only shows the leaf class's own
        for klass in type(self).__mro__:
            for attr in getattr(klass, "__slots__", ()):
                setattr(new, attr, getattr(self, attr))
        return new

    def absorb(self, step):
        """Fold one :class:`CompressedStep` into the running totals."""
        self.flops += step.flops
        self.write += step.out_size
        self.max_size = max(self.max_size, step.out_size)
        self.peak_size = max(
            self.peak_size, self.total_size + step.high_water
        )
        self.total_size += step.live_delta
        self.last = step

    def rebase(self, prev):
        """Recompute this state's totals as if its :attr:`last` step had
        been taken from ``prev`` instead of its original predecessor.

        Used after a window rewrite changes the cost of a chain prefix:
        the suffix hypergraph states are unchanged (so ``total_size`` and
        ``last`` stay valid) but the accumulated totals must be re-derived
        link by link from the new prefix.
        """
        step = self.last
        self.flops = prev.flops + step.flops
        self.write = prev.write + step.out_size
        self.max_size = max(prev.max_size, step.out_size)
        pre_step_total = self.total_size - step.live_delta
        self.peak_size = max(
            prev.peak_size, pre_step_total + step.high_water
        )

    # windowed refinement's historical name for suffix re-accumulation
    update_score = rebase

    # which running total leads the .score, set by subclasses:
    # "max_size" / "peak_size" / "write" / "flops" / "combo"
    leading = None

    @property
    def combo_score(self):
        return math.log2(
            self.flops + DEFAULT_COMBO_FACTOR * self.write + 1
        )

    @property
    def score(self):
        lead = self.leading
        if lead is None:
            raise NotImplementedError
        if lead == "combo":
            f = self.factor or DEFAULT_COMBO_FACTOR
            return math.log2(self.flops + f * self.write + 1)
        if lead == "flops":
            # flops-led scores tiebreak on peak footprint, log10 scale
            return math.log10(self.flops + 1) + (
                self.secondary_weight
                * math.log10(max(self.peak_size, 1))
            )
        return math.log2(max(getattr(self, lead), 1)) + (
            self.secondary_weight * math.log2(self.flops + 1)
        )

    def describe(self, join=" "):
        quantities = (
            ("F", math.log10, self.flops),
            ("C", math.log10,
             self.flops + (self.factor or DEFAULT_COMBO_FACTOR) * self.write),
            ("S", math.log2, self.max_size),
            ("P", math.log2, self.peak_size),
        )
        return join.join(
            f"{label}={log(max(1, value)):.2f}"
            for label, log, value in quantities
        )

    def __repr__(self):
        return f"<{self.__class__.__name__}({self.describe(join=', ')})>"


def tracked_contract_step(hg, tracker, i, j, chi, compress_late, node=None):
    """Contract nodes ``i`` and ``j`` of ``hg`` *in place* (with the
    chi-compressions dictated by ``compress_late``), absorbing the measured
    step into ``tracker``. Returns the new node's id (``node`` if given).
    """
    ij, step = replay_compressed_step(hg, i, j, chi, compress_late, node)
    tracker.absorb(step)
    return ij


class CompressedStatsTrackerSize(CompressedStatsTracker):
    __slots__ = ()
    leading = "max_size"


class CompressedStatsTrackerPeak(CompressedStatsTracker):
    __slots__ = ()
    leading = "peak_size"


class CompressedStatsTrackerWrite(CompressedStatsTracker):
    __slots__ = ()
    leading = "write"


class CompressedStatsTrackerFlops(CompressedStatsTracker):
    __slots__ = ()
    leading = "flops"


class CompressedStatsTrackerCombo(CompressedStatsTracker):
    __slots__ = ()
    leading = "combo"


class CompressedObjective(Objective):
    """Base for objectives scoring a chi-capped compressed contraction.

    Subclasses declare which tracker total leads the trial score
    (``leading``), which get the small tiebreak weight (``tiebreak``),
    and which reports as the trial's "size" (``size_attr``).
    """

    __slots__ = ("chi", "compress_late", "secondary_weight")
    tracker_cls = None
    leading = None
    tiebreak = ()
    size_attr = "max_size"

    def __init__(self, chi="auto", compress_late=False, secondary_weight=1e-3):
        self.chi = chi
        self.compress_late = compress_late
        self.secondary_weight = secondary_weight

    def get_compressed_stats_tracker(self, hg):
        return self.tracker_cls(
            hg, self.chi, secondary_weight=self.secondary_weight
        )

    def compute_compressed_stats(self, trial):
        tree = trial["tree"]
        return tree.compressed_contract_stats(
            chi=self.chi, compress_late=self.compress_late
        )

    def __call__(self, trial):
        stats = self.compute_compressed_stats(trial)
        trial["flops"] = stats.flops
        trial["write"] = stats.write
        trial["size"] = getattr(stats, self.size_attr)
        return math.log2(max(getattr(stats, self.leading), 1)) + sum(
            self.secondary_weight * math.log2(max(getattr(stats, a), 1))
            for a in self.tiebreak
        )


class CompressedSizeObjective(CompressedObjective):
    __slots__ = ()
    tracker_cls = CompressedStatsTrackerSize
    leading = "max_size"
    tiebreak = ("flops", "write")


class CompressedPeakObjective(CompressedObjective):
    __slots__ = ()
    tracker_cls = CompressedStatsTrackerPeak
    leading = "peak_size"
    tiebreak = ("flops", "write")
    size_attr = "peak_size"


class CompressedWriteObjective(CompressedObjective):
    __slots__ = ()
    tracker_cls = CompressedStatsTrackerWrite
    leading = "write"
    tiebreak = ("flops", "peak_size")
    size_attr = "write"


class CompressedFlopsObjective(CompressedObjective):
    __slots__ = ()
    tracker_cls = CompressedStatsTrackerFlops
    leading = "flops"
    tiebreak = ("write", "peak_size")


class CompressedComboObjective(CompressedObjective):
    __slots__ = ("factor",)
    tracker_cls = CompressedStatsTrackerCombo

    def __init__(self, chi="auto", compress_late=False, factor=DEFAULT_COMBO_FACTOR):
        self.factor = factor
        super().__init__(chi=chi, compress_late=compress_late)

    def get_compressed_stats_tracker(self, hg):
        return CompressedStatsTrackerCombo(
            hg, self.chi, factor=self.factor
        )

    def __call__(self, trial):
        stats = self.compute_compressed_stats(trial)
        trial["flops"] = stats.flops
        trial["write"] = stats.write
        trial["size"] = stats.max_size
        return math.log2(max(stats.flops + self.factor * stats.write, 1))


# -- string spec parsing -----------------------------------------------------

_OBJECTIVE_RE = re.compile(
    r"^(?P<name>"
    r"flops|write|size|combo|limit|tpu|gpu|"
    r"flops-compressed|size-compressed|max-compressed|"
    r"peak-compressed|write-compressed|combo-compressed"
    r")"
    r"(?:[-:](?P<factor>[\d.]+))?$"
)


def parse_minimize(minimize):
    """Parse an objective specification (string, Objective, or callable)
    into an Objective instance.
    """
    if isinstance(minimize, Objective):
        return minimize
    if callable(minimize):
        # custom callable objective: score trials directly
        return minimize
    if not isinstance(minimize, str):
        raise TypeError(f"Can't parse objective from {minimize!r}.")
    return _parse_minimize_str(minimize)


@functools.lru_cache(maxsize=None)
def _parse_minimize_str(minimize):

    m = _OBJECTIVE_RE.match(minimize)
    if m is None:
        raise ValueError(f"Unknown objective specification: {minimize!r}.")
    name = m.group("name")
    factor = m.group("factor")

    if name == "flops":
        return FlopsObjective()
    if name == "write":
        return WriteObjective()
    if name == "size":
        return SizeObjective()
    if name == "combo":
        f = float(factor) if factor is not None else DEFAULT_COMBO_FACTOR
        f = int(f) if f == int(f) else f
        return ComboObjective(factor=f)
    if name == "limit":
        f = float(factor) if factor is not None else DEFAULT_COMBO_FACTOR
        f = int(f) if f == int(f) else f
        return LimitObjective(factor=f)
    if name == "gpu":
        if factor is None:
            return GpuTimeObjective()
        return GpuTimeObjective(flops_per_elem=float(factor))
    if name == "tpu":
        raise NotImplementedError(
            f"{minimize!r}: the TPU time model priced a TPU; "
            "cotengra_tpu_torch models the card: minimize='gpu'"
        )

    # compressed objectives: the factor slot is the chi value
    chi = int(factor) if factor is not None else "auto"
    if name in ("max-compressed", "size-compressed"):
        return CompressedSizeObjective(chi=chi)
    if name == "peak-compressed":
        return CompressedPeakObjective(chi=chi)
    if name == "write-compressed":
        return CompressedWriteObjective(chi=chi)
    if name == "flops-compressed":
        return CompressedFlopsObjective(chi=chi)
    if name == "combo-compressed":
        return CompressedComboObjective(chi=chi)
    raise ValueError(minimize)


def get_score_fn(minimize):
    """Alias of :func:`parse_minimize`."""
    return parse_minimize(minimize)


# -- multi-contraction scoring ------------------------------------------------
#
# For batches of index configurations sharing one network (for example
# many amplitudes): each node's cost is multiplied by the expected number
# of distinct configurations of its variable indices.


class MultiObjective(Objective):
    __slots__ = ("num_configs",)

    def __init__(self, num_configs):
        self.num_configs = num_configs

    def compute_mult(self, dims):
        raise NotImplementedError

    def estimate_node_mult(self, tree, node):
        return self.compute_mult(
            [tree.size_dict[ix] for ix in tree.get_node_var_inds(node)]
        )

    def estimate_node_cache_mult(self, tree, node, sliced_ind_ordering):
        node_var_inds = tree.get_node_var_inds(node)
        non_heavy = [
            ix
            for ix in node_var_inds
            if ix not in sliced_ind_ordering[: len(node_var_inds)]
        ]
        return self.compute_mult([tree.size_dict[ix] for ix in non_heavy])

    def __call__(self, trial):
        ensure_basic_quantities(trial)
        return math.log2(trial["flops"]) + 1e-3 * math.log2(trial["size"])


class MultiObjectiveDense(MultiObjective):
    """Every configuration of the variable indices occurs."""

    __slots__ = ()

    def compute_mult(self, dims):
        p = 1
        for d in dims:
            p *= d
        return p


def expected_coupons(num_sub, num_total):
    """Expected number of distinct 'coupons' after ``num_total`` uniform
    draws from ``num_sub`` possibilities."""
    return num_sub * (1 - (1 - 1 / num_sub) ** num_total)


class MultiObjectiveUniform(MultiObjective):
    """Configurations drawn uniformly at random."""

    __slots__ = ()

    def compute_mult(self, dims):
        p = 1
        for d in dims:
            p *= d
        return expected_coupons(p, self.num_configs)


class MultiObjectiveLinear(MultiObjective):
    """The number of distinct configurations grows linearly with the
    number of variable indices (locally connected ones)."""

    __slots__ = ("coeff",)

    def __init__(self, num_configs, coeff=1):
        self.coeff = coeff
        super().__init__(num_configs=num_configs)

    def compute_mult(self, dims):
        return min(self.coeff * len(dims), self.num_configs)


def get_multi_objective(strategy, num_configs, **kwargs):
    if isinstance(strategy, MultiObjective):
        return strategy
    return {
        "dense": MultiObjectiveDense,
        "uniform": MultiObjectiveUniform,
        "linear": MultiObjectiveLinear,
    }[strategy](num_configs, **kwargs)
