"""The hyper-optimizer (counterpart of ``cotengra_tpu/hyper/driver.py``):
ask/tell search over path finder methods and their hyper-parameters, with
refinement stages (simulated annealing, slicing, subtree reconfiguration)
applied per trial.

A method registry (``register_hyper_function``), pluggable samplers
(``register_hyper_optlib``; ``"auto"`` is optuna where installed, else
the in-house cmaes), the trial stack (SA -> slice -> slice+reconf ->
reconf -> score; windowed reconfiguration for compressed trees), trials
pre-dispatched to a pool and harvested in completion order, termination
by ``max_repeats`` / ``max_time`` seconds / ``"rate:F"`` /
``"equil:N"``, and disk-cached reusable optimizers. Pure Python on the
host: with seeded methods, the same seed gives the reference's trials
and best tree. The default methods are the reference's: ``greedy`` and
the native partitioner ``ctgpart`` where the native library builds,
else ``greedy`` and ``labels``. With ``multi_opts`` a trial builds a
multi-contraction tree (``tree_multi.py``) for ``HyperMultiOptimizer``.
"""

import math
import time
import warnings

from ..pathfinders.base import PathOptimizer
from ..scoring import ensure_basic_quantities, parse_minimize
from ..tree import ContractionTree
from ..utils.eqs import hash_contraction
from ..utils.misc import BadTrial, DiskDict, get_rng
from .space import get_optlib, register_hyper_optlib  # noqa: F401

# -- method registry ---------------------------------------------------------

_HYPER_FNS = {}
_HYPER_SPACES = {}
_HYPER_CONSTANTS = {}


def register_hyper_function(name, ssa_func, space, constants=None):
    """Register a pathfinding method for hyper-optimization.

    ``ssa_func(inputs, output, size_dict, **params) -> ssa_path``.
    """
    _HYPER_FNS[name] = ssa_func
    _HYPER_SPACES[name] = dict(space)
    _HYPER_CONSTANTS[name] = dict(constants or {})


def list_hyper_functions():
    return sorted(_HYPER_FNS)


def get_hyper_space():
    return _HYPER_SPACES


def _default_methods():
    # the native multilevel partitioner (the kahypar slot) where its
    # library builds; labels is the dependency-free fallback
    from ..pathfinders.partition import ctgpart_available

    cands = (
        (["greedy", "ctgpart"],) if ctgpart_available() else ()
    ) + (["greedy", "labels"], ["greedy"])
    for cand in cands:
        if all(m in _HYPER_FNS for m in cand):
            return cand
    return list(_HYPER_FNS)[:1]


# -- the per-trial work (top-level so it pickles for process pools) -----------


def run_trial(
    inputs,
    output,
    size_dict,
    method,
    params,
    minimize="flops",
    simulated_annealing_opts=None,
    slicing_opts=None,
    slicing_reconf_opts=None,
    reconf_opts=None,
    tree_class=None,
    multi_opts=None,
):
    """Build a tree with ``method``/``params`` and apply the refinement
    stack, returning the scored trial dict.
    """
    t0 = time.time()
    ssa_path = _HYPER_FNS[method](inputs, output, size_dict, **params)

    if tree_class is None:
        tree_class = ContractionTree

    if multi_opts is not None:
        from ..scoring import get_multi_objective
        from ..tree_multi import ContractionTreeMulti

        tree = ContractionTreeMulti.from_path(
            inputs, output, size_dict, ssa_path=ssa_path
        )
        tree.sliced_inds = {
            ix: None for ix in multi_opts.get("varmults", ())
        }
        tree.set_default_objective(
            get_multi_objective(
                multi_opts.get("strategy", "uniform"),
                multi_opts.get("numconfigs", 1),
            )
        )
    else:
        tree = tree_class.from_path(
            inputs,
            output,
            size_dict,
            ssa_path=ssa_path,
            objective=minimize,
        )

    compressed = getattr(tree, "total_flops_exact", None) is not None

    if simulated_annealing_opts is not None and not compressed:
        from ..pathfinders.annealing import simulated_anneal_tree

        simulated_anneal_tree(
            tree, minimize=minimize, inplace=True,
            **simulated_annealing_opts,
        )
    if slicing_opts is not None and not compressed:
        tree.slice_(**slicing_opts)
    if slicing_reconf_opts is not None and not compressed:
        opts = dict(slicing_reconf_opts)
        target_size = opts.pop("target_size")
        tree.slice_and_reconfigure_(target_size, minimize=minimize, **opts)
    if reconf_opts is not None:
        if compressed:
            tree.windowed_reconfigure_(
                minimize=minimize,
                **{
                    k: v
                    for k, v in reconf_opts.items()
                    if k
                    in (
                        "window_size",
                        "max_iterations",
                        "score_temperature",
                        "seed",
                    )
                },
            )
        else:
            opts = dict(reconf_opts)
            opts.setdefault("minimize", minimize)
            tree.subtree_reconfigure_(**opts)

    trial = {
        "tree": tree,
        "method": method,
        "params": params,
        "time": time.time() - t0,
    }
    ensure_basic_quantities(trial)
    return trial


class HyperOptimizer(PathOptimizer):
    """Search over (method, hyper-parameters) to find a high-quality
    contraction tree.

    Parameters
    ----------
    methods : None, str or sequence[str]
        Pathfinder methods to sample from (default: greedy [+ labels]).
    minimize : str or Objective
        The score to minimize.
    max_repeats : int
        Maximum number of trials.
    max_time : None, number, "rate:F" or "equil:N"
        Extra stopping conditions: wall seconds; stop when estimated
        contraction time at F flops/s is less than the time already spent
        searching; or stop after N trials with no improvement.
    optlib : str
        Sampler: "auto" (optuna, else cmaes), or any registered name
        ("random", "evo"/"sses", "nm", "sbplx", "cmaes", "de", "pe",
        "scipy", ...).
    parallel : bool, int, str or pool
        Trial parallelism on the host (see
        ``parallel.pools.parse_parallel_arg``). Plan with ``False`` or
        threads in a process that has initialised CUDA.
    slicing_opts, slicing_reconf_opts, reconf_opts,
    simulated_annealing_opts : dict, optional
        Enable the corresponding per-trial refinement.
    on_trial_error : {"warn", "raise", "ignore"}
    progbar : bool
    """

    compressed = False
    multicontraction = False

    def __init__(
        self,
        methods=None,
        minimize="flops",
        max_repeats=128,
        max_time=None,
        optlib="auto",
        parallel=False,
        slicing_opts=None,
        slicing_reconf_opts=None,
        reconf_opts=None,
        simulated_annealing_opts=None,
        score_compression=0.75,
        on_trial_error="warn",
        progbar=False,
        seed=None,
        **optlib_opts,
    ):
        if methods is None:
            methods = _default_methods()
        elif isinstance(methods, str):
            methods = [methods]
        self._methods = list(methods)
        for m in self._methods:
            if m not in _HYPER_FNS:
                raise ValueError(
                    f"Unknown hyper method {m!r}; have "
                    f"{list_hyper_functions()}"
                )
        self.minimize = minimize
        self.objective = parse_minimize(minimize)
        self.max_repeats = max_repeats
        self.max_time = max_time
        self.parallel = parallel
        self.slicing_opts = (
            dict(slicing_opts) if slicing_opts is not None else None
        )
        self.slicing_reconf_opts = (
            dict(slicing_reconf_opts)
            if slicing_reconf_opts is not None
            else None
        )
        self.reconf_opts = (
            dict(reconf_opts) if reconf_opts is not None else None
        )
        self.simulated_annealing_opts = (
            dict(simulated_annealing_opts)
            if simulated_annealing_opts is not None
            else None
        )
        self.score_compression = score_compression
        self.on_trial_error = on_trial_error
        self.progbar = progbar
        self.rng = get_rng(seed)

        self.optlib = get_optlib(optlib)(
            self._methods,
            _HYPER_SPACES,
            _HYPER_CONSTANTS,
            seed=self.rng.randrange(2**32),
            **optlib_opts,
        )
        self.trials = []
        self.best = None
        self.best_score = float("inf")

    @property
    def tree(self):
        return self.best["tree"]

    @property
    def path(self):
        return self.best["tree"].get_path()

    tree_class = None
    multi_opts = None

    def _trial_kwargs(self):
        return dict(
            minimize=self.minimize,
            simulated_annealing_opts=self.simulated_annealing_opts,
            slicing_opts=self.slicing_opts,
            slicing_reconf_opts=self.slicing_reconf_opts,
            reconf_opts=self.reconf_opts,
            tree_class=self.tree_class,
            multi_opts=self.multi_opts,
        )

    def _score_trial(self, trial):
        try:
            score = self.objective(trial)
        except BadTrial:
            score = float("inf")
        trial["score"] = score
        # compressed + smudged score reported to the sampler, to even out
        # the landscape and avoid premature convergence. Sign-preserving
        # power: a custom objective may be negative, and a bare x**0.75
        # would go complex there
        reported = math.copysign(
            abs(score) ** self.score_compression, score
        ) + self.rng.gauss(0, 1e-6)
        return reported

    def _handle_trial_error(self, exc):
        self._last_trial_error = exc
        if self.on_trial_error == "raise":
            raise exc
        if self.on_trial_error == "warn":
            warnings.warn(
                f"Trial error: {exc!r} (reporting inf score)."
            )

    def _should_stop(self, t_start, since_best):
        mt = self.max_time
        if mt is None:
            return False
        elapsed = time.time() - t_start
        if isinstance(mt, (int, float)):
            return elapsed > mt
        if isinstance(mt, str):
            if mt.startswith("rate:"):
                rate = float(mt[5:])
                if self.best is None:
                    return False
                est = self.best["flops"] / rate
                return est < elapsed
            if mt.startswith("equil:"):
                return since_best >= int(mt[6:])
        raise ValueError(f"Can't parse max_time={mt!r}")

    def _record(self, method, params, trial):
        reported = self._score_trial(trial)
        self.optlib.tell(method, params, reported)
        self.trials.append(trial)
        improved = trial["score"] < self.best_score
        if improved:
            self.best_score = trial["score"]
            self.best = trial
        return improved

    def search(self, inputs, output, size_dict):
        inputs = tuple(map(tuple, inputs))
        output = tuple(output)
        t_start = time.time()
        since_best = 0
        # the best tree answers for the contraction of this search: an
        # optimizer searched again (``auto`` reuses one per thread) must
        # not return an earlier contraction's tree. The reference keeps
        # it, and so can return a tree of other inputs (ROADMAP C).
        self.best = None
        self.best_score = float("inf")

        from ..parallel.pools import get_pool_size, parse_parallel_arg

        pool = parse_parallel_arg(self.parallel)

        if self.progbar:
            try:
                import tqdm

                pbar = tqdm.tqdm(total=self.max_repeats)
            except ImportError:
                pbar = None
        else:
            pbar = None

        def finish_trial(method, params, trial_or_exc):
            nonlocal since_best
            if isinstance(trial_or_exc, Exception):
                self._handle_trial_error(trial_or_exc)
                trial = {
                    "tree": None,
                    "method": method,
                    "params": params,
                    "flops": float("inf"),
                    "write": float("inf"),
                    "size": float("inf"),
                    "score": float("inf"),
                }
                self.optlib.tell(method, params, float("inf"))
                self.trials.append(trial)
                since_best += 1
                return
            improved = self._record(method, params, trial_or_exc)
            since_best = 0 if improved else since_best + 1
            if pbar is not None:
                pbar.update()
                if self.best is not None:
                    pbar.set_description(
                        f"log2[SIZE]: {math.log2(self.best['size']):.2f} "
                        f"log10[FLOPs]: "
                        f"{math.log10(self.best['flops']):.2f}"
                    )

        repeats_left = self.max_repeats

        if pool is None:
            while repeats_left > 0 and not self._should_stop(
                t_start, since_best
            ):
                repeats_left -= 1
                method, params = self.optlib.ask()
                try:
                    trial = run_trial(
                        inputs, output, size_dict, method, params,
                        **self._trial_kwargs(),
                    )
                except Exception as exc:
                    trial = exc
                finish_trial(method, params, trial)
        else:
            import concurrent.futures as cf

            nworkers = get_pool_size(pool)
            prefetch = max(nworkers + 4, int(1.2 * nworkers))
            pending = {}
            while (repeats_left > 0 or pending) and not (
                self._should_stop(t_start, since_best)
            ):
                while repeats_left > 0 and len(pending) < prefetch:
                    repeats_left -= 1
                    method, params = self.optlib.ask()
                    fut = pool.submit(
                        run_trial,
                        inputs, output, size_dict, method, params,
                        **self._trial_kwargs(),
                    )
                    pending[fut] = (method, params)
                if isinstance(next(iter(pending)), cf.Future):
                    done, _ = cf.wait(
                        pending, return_when=cf.FIRST_COMPLETED
                    )
                else:
                    # non-concurrent.futures pool (e.g. ray): poll
                    done = [
                        f for f in pending if f.done()
                    ]
                    if not done:
                        time.sleep(0.005)
                        continue
                for fut in done:
                    method, params = pending.pop(fut)
                    try:
                        trial = fut.result()
                    except Exception as exc:
                        trial = exc
                    finish_trial(method, params, trial)
            for fut in pending:
                fut.cancel()

        if pbar is not None:
            pbar.close()

        if self.best is None:
            last = getattr(self, "_last_trial_error", None)
            raise RuntimeError(
                "All hyper-optimizer trials failed."
                + (f" Last error: {last!r}" if last is not None else "")
            )
        return self.best["tree"]

    def ssa_path(self, inputs, output, size_dict):
        return self.search(inputs, output, size_dict).get_ssa_path()

    def __call__(self, *args, **kwargs):
        inputs, output, size_dict = self._detect_opt_einsum_call(args)
        return self.search(inputs, output, size_dict).get_path()

    # -- introspection --

    def get_trials(self, sort=None):
        """The trials, in the order they finished or sorted by the key
        ``sort`` (``"score"``, ``"flops"``, ...; a trial without it goes
        last)."""
        trials = list(self.trials)
        if sort is not None:
            trials.sort(key=lambda t: t.get(sort, float("inf")))
        return trials

    def print_trials(self, sort="score"):
        """Print one line per trial: method, log10 flops, log2 size and
        score."""
        for t in self.get_trials(sort):
            flops = t.get("flops", float("inf"))
            size = t.get("size", float("inf"))
            print(
                f"{t['method']:>12} "
                f"F={math.log10(max(flops, 1)):.2f} "
                f"S={math.log2(max(size, 1)):.2f} "
                f"score={t.get('score', float('inf')):.3f}"
            )

    def to_df(self):
        """The trials as a ``pandas.DataFrame`` (pandas is needed here
        only), one column per parameter as ``param_<name>``."""
        import pandas as pd

        rows = []
        for t in self.trials:
            rows.append(
                {
                    "method": t["method"],
                    "flops": t.get("flops"),
                    "size": t.get("size"),
                    "write": t.get("write"),
                    "score": t.get("score"),
                    **{
                        f"param_{k}": v
                        for k, v in t.get("params", {}).items()
                    },
                }
            )
        return pd.DataFrame(rows)


class ReusableHyperOptimizer(PathOptimizer):
    """Content-addressed cache around a HyperOptimizer: repeated calls with
    the same contraction hit the (optionally on-disk) cache instead of
    re-searching. ``hash_method="a"`` keys on the canonically relabelled
    contraction, ``"b"`` on a permutation-invariant hash; ``overwrite``
    may be ``True``, ``False`` or ``"improved"``.
    """

    def __init__(
        self,
        directory=None,
        overwrite=False,
        cache_only=False,
        hash_method="a",
        **opt_kwargs,
    ):
        self.directory = directory
        self._cache = DiskDict(directory)
        self.overwrite = overwrite
        self.cache_only = cache_only
        self.hash_method = hash_method
        self.opt_kwargs = opt_kwargs
        self.last_opt = None

    def hash_query(self, inputs, output, size_dict):
        if self.hash_method == "b":
            # permutation/relabel invariant (WL refinement)
            from ..utils.io import hash_contraction_b

            base = hash_contraction_b(inputs, output, size_dict)
            return (
                base
                + "-"
                + str(self.opt_kwargs.get("minimize", "flops"))
            )
        return hash_contraction(
            inputs,
            output,
            size_dict,
            minimize=str(self.opt_kwargs.get("minimize", "flops")),
        )

    def _search_and_pack(self, inputs, output, size_dict):
        opt = HyperOptimizer(**self.opt_kwargs)
        self.last_opt = opt
        tree = opt.search(inputs, output, size_dict)
        return {
            "ssa_path": tree.get_ssa_path(),
            "sliced_inds": tuple(
                (ix, si.project) for ix, si in tree.sliced_inds.items()
            ),
            "score": opt.best_score,
            "flops": opt.best["flops"],
        }, tree

    def _unpack(self, record, inputs, output, size_dict):
        tree = ContractionTree.from_path(
            inputs,
            output,
            size_dict,
            ssa_path=record["ssa_path"],
            objective=self.opt_kwargs.get("minimize", "flops"),
        )
        for ix, project in record["sliced_inds"]:
            tree.remove_ind_(ix, project=project)
        return tree

    def search(self, inputs, output, size_dict):
        inputs = tuple(map(tuple, inputs))
        output = tuple(output)
        key = self.hash_query(inputs, output, size_dict)
        have = key in self._cache

        if have and not self.overwrite:
            return self._unpack(
                self._cache[key], inputs, output, size_dict
            )
        if self.cache_only and not have:
            raise KeyError(
                f"Contraction missing from cache_only optimizer: {key}"
            )

        record, tree = self._search_and_pack(inputs, output, size_dict)
        if (
            not have
            or self.overwrite is True
            or (
                self.overwrite == "improved"
                and record["score"] < self._cache[key]["score"]
            )
        ):
            self._cache[key] = record
        elif have and self.overwrite == "improved":
            return self._unpack(
                self._cache[key], inputs, output, size_dict
            )
        return tree

    def ssa_path(self, inputs, output, size_dict):
        return self.search(inputs, output, size_dict).get_ssa_path()

    def __call__(self, *args, **kwargs):
        inputs, output, size_dict = self._detect_opt_einsum_call(args)
        return self.search(inputs, output, size_dict).get_path()

    def cleanup(self):
        self._cache.cleanup(delete_dir=True)

    def __len__(self):
        return len(self._cache)


class ReusableRandomGreedyOptimizer(ReusableHyperOptimizer):
    """Content-addressed cache around the batched random-greedy search:
    the same disk-cache/overwrite/hash machinery as
    :class:`ReusableHyperOptimizer`, but each miss runs a
    :class:`~cotengra_tpu_torch.pathfinders.basic.RandomGreedyOptimizer`.
    """

    def _search_and_pack(self, inputs, output, size_dict):
        from ..pathfinders.basic import RandomGreedyOptimizer

        opt = RandomGreedyOptimizer(**self.opt_kwargs)
        self.last_opt = opt
        ssa_path = opt.ssa_path(inputs, output, size_dict)
        tree = ContractionTree.from_path(
            inputs, output, size_dict, ssa_path=ssa_path
        )
        return {
            "ssa_path": ssa_path,
            "sliced_inds": (),
            "score": opt.best_flops,
            "flops": opt.best_flops,
        }, tree

    def hash_query(self, inputs, output, size_dict):
        if self.hash_method == "b":
            from ..utils.io import hash_contraction_b

            return hash_contraction_b(inputs, output, size_dict) + "-rg"
        return hash_contraction(
            inputs, output, size_dict, minimize="flops-rg"
        )

    def _unpack(self, record, inputs, output, size_dict):
        return ContractionTree.from_path(
            inputs, output, size_dict, ssa_path=record["ssa_path"]
        )
