"""Simulated annealing refinement of contraction trees (counterpart of
``cotengra_tpu/pathfinders/annealing.py``).

Local moves are the 3-node rotations ``((A B) C) -> ((A C) B) | ((B C) A)``
with Metropolis acceptance over a geometric temperature ladder, after
arXiv:2108.05665 (Kalachev et al.) and OMEinsumContractionOrders' "treesa".
Optional interleaved re-slicing keeps a sliced tree within a size target
while annealing (``mode``), and ``parallel_temper_tree`` runs a population
over a temperature ladder with replica exchange.
"""

import math

from ..scoring import parse_minimize
from ..tree import legs_union
from ..utils.misc import compute_size_by_dict, get_rng


def _pair_stats(tree, na, nb):
    """legs/size/flops of the hypothetical pairwise contraction of nodes
    ``na``, ``nb`` - without mutating the tree.
    """
    la = tree.get_legs(na)
    lb = tree.get_legs(nb)
    involved = legs_union((la, lb))
    legs = {
        ix: c for ix, c in involved.items() if c < tree.appearances[ix]
    }
    flops = compute_size_by_dict(involved, tree.size_dict)
    size = compute_size_by_dict(legs, tree.size_dict)
    return legs, size, flops


def _node_stats(tree, node):
    return tree.get_size(node), tree.get_flops(node)


def _slice_step_basic(tree, cur_target, temp, rng, unslice=1):
    """Unslice ``unslice`` random indices then re-slice to the current
    target."""
    for _ in range(unslice):
        if not tree.sliced_inds:
            break
        tree.unslice_rand_(seed=rng)
    if tree.max_size() > cur_target:
        tree.slice_(
            target_size=cur_target, temperature=temp, max_repeats=4
        )


def _slice_step_reslice(tree, cur_target, temp, rng):
    """Probabilistically unslice then enforce the target (the 'reslice'
    mode)."""
    if tree.sliced_inds and rng.random() < 0.5:
        tree.unslice_rand_(seed=rng)
    if tree.max_size() > cur_target:
        tree.slice_(
            target_size=cur_target, temperature=temp, max_repeats=4
        )


def _slice_step_drift(tree, cur_target, temp, rng):
    """Drift mode: while oversize,
    slice one more index with probability 3/4, otherwise drift back by
    unslicing a random index. Not guaranteed to hit the target - more
    explorative over long schedules."""
    oversize = tree.max_size() > cur_target
    if oversize and rng.random() < 0.75:
        tree.slice_(target_slices=2, temperature=temp, max_repeats=4)
    elif tree.sliced_inds:
        tree.unslice_rand_(seed=rng)


def simulated_anneal_tree(
    tree,
    tsteps=50,
    tmax=0.01,
    tmin=0.001,
    tstrategy="linear",
    numiter=1,
    minimize=None,
    target_size=None,
    target_size_initial=None,
    mode="basic",
    seed=None,
    inplace=False,
    progbar=False,
):
    """Anneal ``tree`` with local subtree rotations.

    Parameters
    ----------
    tree : ContractionTree
    tsteps : int
        Number of temperature steps.
    tmax, tmin : float
        Temperature ladder range.
    numiter : int
        Rotation sweeps per temperature step.
    minimize : str or Objective, optional
    target_size : int, optional
        If given, interleave slicing with annealing: a geometric
        schedule of intermediate targets runs from the current (or
        ``target_size_initial``) size down to ``target_size`` across the
        temperature steps, and ``mode`` selects the per-step slicing
        move.
    target_size_initial : int, optional
        Starting point of the slicing schedule (default: current size).
    mode : {"basic", "reslice", "drift"} or int
        ``"basic"`` unslices one random index then re-slices to the
        scheduled target; an integer does the same with that many
        unslices; ``"reslice"`` probabilistically unslices then
        enforces the target; ``"drift"`` randomly walks the slice set
        (3/4 slice-deeper when oversize, else unslice) without
        guaranteeing the target - best for long explorative schedules.
    seed : int or Random, optional
    inplace : bool, optional
    """
    tree = tree if inplace else tree.copy()
    objective = parse_minimize(
        minimize if minimize is not None else tree.get_default_objective()
    )
    rng = get_rng(seed)

    if tstrategy == "linear":
        temps = [
            tmax + (tmin - tmax) * s / max(tsteps - 1, 1)
            for s in range(tsteps)
        ]
    else:  # geometric
        ratio = (tmin / tmax) ** (1.0 / max(tsteps - 1, 1))
        temps = [tmax * ratio**s for s in range(tsteps)]

    if target_size is not None:
        if isinstance(mode, int) and not isinstance(mode, bool):
            import functools as _ft

            slice_step = _ft.partial(_slice_step_basic, unslice=mode)
        else:
            slice_step = {
                "basic": _slice_step_basic,
                "reslice": _slice_step_reslice,
                "drift": _slice_step_drift,
            }[mode]
        # geometric target-size schedule from the current size down
        size0 = max(
            target_size_initial
            if target_size_initial is not None
            else tree.max_size(),
            target_size,
        )
        r = (target_size / size0) ** (1.0 / max(tsteps - 1, 1))
        targets = [max(size0 * r**s, target_size) for s in range(tsteps)]
    else:
        slice_step = None
        targets = [None] * tsteps

    for temp, cur_target in zip(temps, targets):
        if slice_step is not None:
            slice_step(tree, cur_target, temp, rng)

        for _ in range(numiter):
            candidates = [
                p
                for p, (l, r) in tree.children.items()
                if (l in tree.children) or (r in tree.children)
            ]
            rng.shuffle(candidates)

            for p in candidates:
                if p not in tree.children:
                    continue
                l, r = tree.children[p]
                # choose an internal child to rotate through; with both
                # internal this covers the four rotation rules
                internal = [n for n in (l, r) if n in tree.children]
                if not internal:
                    continue
                x = rng.choice(internal)
                other = r if x is l else l
                a, b = tree.children[x]
                # candidate rotation: ((a b) other) -> ((a other) b)
                #                                    | ((b other) a)
                keep, move = (a, b) if rng.random() < 0.5 else (b, a)
                # evaluate: replace intermediate x=(a|b) by keep|other
                old_size, old_flops = _node_stats(tree, x)
                _, p_size, old_p_flops = (
                    tree.get_legs(p),
                    tree.get_size(p),
                    tree.get_flops(p),
                )
                new_legs, new_size, new_flops = _pair_stats(
                    tree, keep, other
                )
                new_node = keep | other
                new_p_flops = compute_size_by_dict(
                    legs_union((new_legs, tree.get_legs(move))),
                    tree.size_dict,
                )

                old_score = objective.score_local(
                    flops=(old_flops, old_p_flops),
                    size=(old_size, p_size),
                )
                new_score = objective.score_local(
                    flops=(new_flops, new_p_flops),
                    size=(new_size, p_size),
                )
                dE = new_score - old_score

                if dE <= 0 or (
                    temp > 0 and rng.random() < math.exp(-dE / temp)
                ):
                    if new_node in tree.children or new_node == p:
                        # degenerate (repeated leaf sets)
                        continue
                    tree._remove_node(p)
                    tree._remove_node(x)
                    nl = tree.contract_nodes_pair(keep, other)
                    tree.contract_nodes_pair(nl, move)

    if target_size is not None and mode != "drift":
        # drift mode deliberately floats; the rest enforce the target
        if tree.max_size() > target_size:
            tree.slice_(target_size=target_size, max_repeats=8)

    tree.contraction_cores.clear()
    return tree


def parallel_temper_tree(
    tree,
    num_replicas=4,
    tmax=0.05,
    tmin=0.001,
    rounds=8,
    tsteps_per_round=8,
    minimize=None,
    target_size=None,
    coeff_size_penalty=1.0,
    seed=None,
    parallel=False,
    inplace=False,
    **anneal_opts,
):
    """Parallel tempering: a population of replicas annealed at a ladder
    of temperatures with periodic best-exchange.

    When ``target_size`` is given it is forwarded to the per-replica
    anneals (default ``mode="drift"``, the most explorative) and replica
    ranking adds ``coeff_size_penalty * log2(size / target)`` for
    oversize trees.
    """
    rng = get_rng(seed)
    objective = parse_minimize(
        minimize if minimize is not None else tree.get_default_objective()
    )
    ratio = (tmin / tmax) ** (1.0 / max(num_replicas - 1, 1))
    ladder = [tmax * ratio**i for i in range(num_replicas)]
    replicas = [tree.copy() for _ in range(num_replicas)]

    if target_size is not None:
        anneal_opts.setdefault("mode", "drift")
        anneal_opts["target_size"] = target_size

    def score(t):
        from ..scoring import ensure_basic_quantities

        trial = {"tree": t}
        ensure_basic_quantities(trial)
        x = objective(trial)
        if target_size is not None:
            x += coeff_size_penalty * math.log2(
                max(trial["size"] / target_size, 1)
            )
        return x

    from ..parallel.pools import parse_parallel_arg, submit

    pool = parse_parallel_arg(parallel)

    for _ in range(rounds):
        if pool is None:
            replicas = [
                simulated_anneal_tree(
                    t,
                    tsteps=tsteps_per_round,
                    tmax=temp,
                    tmin=temp * 0.5,
                    minimize=minimize,
                    seed=rng.randrange(2**32),
                    inplace=True,
                    **anneal_opts,
                )
                for t, temp in zip(replicas, ladder)
            ]
        else:
            futs = [
                submit(
                    pool,
                    simulated_anneal_tree,
                    t,
                    tsteps=tsteps_per_round,
                    tmax=temp,
                    tmin=temp * 0.5,
                    minimize=minimize,
                    seed=rng.randrange(2**32),
                    **anneal_opts,
                )
                for t, temp in zip(replicas, ladder)
            ]
            replicas = [f.result() for f in futs]

        # exchange: sort replicas by quality, best goes to lowest temp
        replicas.sort(key=score)

    best = min(replicas, key=score)
    if inplace:
        tree.children = best.children
        tree._legs = best._legs
        tree._involved = best._involved
        tree._size = best._size
        tree._flops = best._flops
        tree._tracked = best._tracked
        tree._tot_flops = best._tot_flops
        tree._tot_write = best._tot_write
        tree._sizes = best._sizes
        tree.sliced_inds = best.sliced_inds
        tree.sliced_inputs = best.sliced_inputs
        tree.multiplicity = best.multiplicity
        tree.contraction_cores.clear()
        return tree
    return best
