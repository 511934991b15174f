"""Additional hyper-parameter samplers (counterpart of
``cotengra_tpu/hyper/optlibs.py``).

- in-house, dependency-free, in a uniform [0,1]^d mapped space: ``nm``
  (whole Nelder-Mead), ``sbplx`` (Subplex), ``cmaes`` (separable
  CMA-ES), ``de`` (differential evolution), ``pe`` (parallel (1+1)-ES);
- ``scipy``: scipy's global optimizers inverted into ask/tell;
- ``optuna`` / ``nevergrad`` / ``skopt``: thin adapters registered by
  ``register_optional_optlibs`` only when the library is importable.

All samplers speak the same ask/tell interface as
:class:`~cotengra_tpu_torch.hyper.space.HyperOptLib`.
"""

import math

from .space import HyperOptLib, register_hyper_optlib, sample_uniform


def _to_unit(spec, value):
    t = spec["type"]
    if t == "FLOAT":
        lo, hi = spec["min"], spec["max"]
        return (value - lo) / ((hi - lo) or 1.0)
    if t == "FLOAT_EXP":
        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        return (math.log(max(value, 1e-300)) - lo) / ((hi - lo) or 1.0)
    if t == "INT":
        lo, hi = spec["min"], spec["max"]
        return (value - lo) / ((hi - lo) or 1.0)
    if t == "BOOL":
        return 1.0 if value else 0.0
    if t == "STRING":
        opts = spec["options"]
        return opts.index(value) / max(len(opts) - 1, 1)
    raise ValueError(t)


def _from_unit(spec, u):
    u = min(max(u, 0.0), 1.0)
    t = spec["type"]
    if t == "FLOAT":
        lo, hi = spec["min"], spec["max"]
        return lo + u * (hi - lo)
    if t == "FLOAT_EXP":
        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        return math.exp(lo + u * (hi - lo))
    if t == "INT":
        lo, hi = spec["min"], spec["max"]
        return int(round(lo + u * (hi - lo)))
    if t == "BOOL":
        return u >= 0.5
    if t == "STRING":
        opts = spec["options"]
        return opts[min(int(u * len(opts)), len(opts) - 1)]
    raise ValueError(t)


class NelderMeadOptLib(HyperOptLib):
    """Nelder-Mead simplex search per method, in the unit-mapped space.

    Maintains a simplex of d+1 points; each ask proposes the canonical
    reflection/expansion/contraction candidate for the current worst
    vertex; tell folds the result back into the simplex. Falls back to
    uniform sampling while the simplex is filling or for empty spaces.
    """

    def __init__(self, methods, spaces, constants, seed=None, **kwargs):
        super().__init__(methods, spaces, constants, seed=seed)
        # per method: list of (score, unit-vector), and a pending proposal
        self.simplex = {m: [] for m in self.methods}
        self.pending = {}

    def _dims(self, method):
        return sorted(self.spaces[method])

    def _vec_to_params(self, method, vec):
        space = self.spaces[method]
        return {
            name: _from_unit(space[name], u)
            for name, u in zip(self._dims(method), vec)
        }

    def ask(self):
        method = self.choose_method()
        space = self.spaces[method]
        dims = self._dims(method)
        d = len(dims)
        simplex = self.simplex[method]

        if d == 0 or len(simplex) < d + 1:
            params = sample_uniform(space, self.rng)
            vec = [
                _to_unit(space[name], params[name]) for name in dims
            ]
        else:
            simplex.sort(key=lambda sv: sv[0])
            worst = simplex[-1][1]
            centroid = [
                sum(v[i] for _, v in simplex[:-1]) / d for i in range(d)
            ]
            # reflection with a dash of noise to escape degenerate
            # simplices
            vec = [
                c + 1.0 * (c - w) + self.rng.gauss(0, 0.02)
                for c, w in zip(centroid, worst)
            ]
            params = self._vec_to_params(method, vec)
        full = {**self.constants.get(method, {}), **params}
        self.pending[(method, tuple(sorted(params.items())))] = vec
        return method, full

    def tell(self, method, params, score):
        super().tell(method, params, score)
        space = self.spaces[method]
        bare = {k: v for k, v in params.items() if k in space}
        key = (method, tuple(sorted(bare.items())))
        vec = self.pending.pop(key, None)
        if vec is None:
            vec = [
                _to_unit(space[name], bare[name])
                for name in self._dims(method)
            ]
        if not math.isfinite(score):
            return
        simplex = self.simplex[method]
        simplex.append((score, vec))
        d = len(self._dims(method))
        simplex.sort(key=lambda sv: sv[0])
        del simplex[d + 1:]


class SubplexOptLib(HyperOptLib):
    """Subplex (Rowan 1990) sampler — the in-house heavy hitter.

    One :class:`~cotengra_tpu_torch.hyper.simplex.SubplexSampler` per
    method in the unit-mapped space. Fully asynchronous: blocked
    sub-simplices yield filler points, so parallel pre-dispatch of many
    trials before any results is safe.
    """

    def __init__(self, methods, spaces, constants, seed=None, **kwargs):
        from .simplex import SubplexSampler

        super().__init__(methods, spaces, constants, seed=seed)
        self.samplers = {}
        for m in self.methods:
            self.samplers[m] = SubplexSampler(
                ndim=len(self.spaces[m]),
                seed=self.rng.randrange(2**31),
                **kwargs,
            )
        # (method, params-key) -> FIFO of outstanding sampler tokens
        self.pending = {}

    def _dims(self, method):
        return sorted(self.spaces[method])

    def ask(self):
        method = self.choose_method()
        space = self.spaces[method]
        token, vec = self.samplers[method].ask()
        params = {
            name: _from_unit(space[name], u)
            for name, u in zip(self._dims(method), vec)
        }
        key = (method, tuple(sorted(params.items())))
        self.pending.setdefault(key, []).append(token)
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        space = self.spaces[method]
        bare = {k: v for k, v in params.items() if k in space}
        key = (method, tuple(sorted(bare.items())))
        fifo = self.pending.get(key)
        if fifo:
            token = fifo.pop(0)
            if not fifo:
                del self.pending[key]
        else:
            # trial not issued by us (e.g. replayed from cache): feed it
            # through a fresh token so the best-point tracking still sees
            # it, by synthesizing an ask-free tell
            sampler = self.samplers[method]
            vec = [
                _to_unit(space[name], bare[name])
                for name in self._dims(method)
            ]
            token, _ = sampler._issue("free", None, None, vec)
        if not math.isfinite(score):
            score = 1e300
        self.samplers[method].tell(token, score)


class WholeNelderMeadOptLib(SubplexOptLib):
    """Full Nelder-Mead (single-subspace subplex: one NM core over all
    dimensions, with step rescaling and local/global restarts)."""

    def __init__(self, methods, spaces, constants, seed=None, **kwargs):
        kwargs.setdefault("nsmin", 10**9)
        kwargs.setdefault("nsmax", 10**9)
        super().__init__(
            methods, spaces, constants, seed=seed, **kwargs
        )


register_hyper_optlib("nm", WholeNelderMeadOptLib)
register_hyper_optlib("sbplx", SubplexOptLib)


class OptunaOptLib(HyperOptLib):
    """optuna TPE adapter (only if optuna is installed)."""

    def __init__(self, methods, spaces, constants, seed=None, **kwargs):
        import optuna

        super().__init__(methods, spaces, constants, seed=seed)
        optuna.logging.set_verbosity(optuna.logging.WARNING)
        self._optuna = optuna
        self.study = optuna.create_study(
            sampler=optuna.samplers.TPESampler(seed=seed),
            direction="minimize",
        )
        self._trials = {}

    def ask(self):
        trial = self.study.ask()
        if len(self.methods) > 1:
            method = trial.suggest_categorical("method", self.methods)
        else:
            method = self.methods[0]
        params = {}
        for name, spec in self.spaces[method].items():
            key = f"{method}__{name}"
            t = spec["type"]
            if t == "FLOAT":
                params[name] = trial.suggest_float(
                    key, spec["min"], spec["max"]
                )
            elif t == "FLOAT_EXP":
                params[name] = trial.suggest_float(
                    key, spec["min"], spec["max"], log=True
                )
            elif t == "INT":
                params[name] = trial.suggest_int(
                    key, spec["min"], spec["max"]
                )
            elif t == "BOOL":
                params[name] = trial.suggest_categorical(
                    key, [False, True]
                )
            else:
                params[name] = trial.suggest_categorical(
                    key, list(spec["options"])
                )
        full = {**self.constants.get(method, {}), **params}
        self._trials[(method, tuple(sorted(params.items())))] = trial
        return method, full

    def tell(self, method, params, score):
        super().tell(method, params, score)
        bare = {
            k: v
            for k, v in params.items()
            if k in self.spaces[method]
        }
        trial = self._trials.pop(
            (method, tuple(sorted(bare.items()))), None
        )
        if trial is not None:
            value = score if math.isfinite(score) else 1e30
            self.study.tell(trial, value)


class NevergradOptLib(HyperOptLib):
    """nevergrad adapter (only if nevergrad is installed)."""

    def __init__(
        self, methods, spaces, constants, seed=None, budget=1024, **kwargs
    ):
        import nevergrad as ng

        super().__init__(methods, spaces, constants, seed=seed)
        self._by_method = {}
        for m in self.methods:
            kw = {}
            for name, spec in spaces[m].items():
                t = spec["type"]
                if t == "FLOAT":
                    kw[name] = ng.p.Scalar(
                        lower=spec["min"], upper=spec["max"]
                    )
                elif t == "FLOAT_EXP":
                    kw[name] = ng.p.Log(
                        lower=spec["min"], upper=spec["max"]
                    )
                elif t == "INT":
                    kw[name] = ng.p.Scalar(
                        lower=spec["min"], upper=spec["max"]
                    ).set_integer_casting()
                elif t == "BOOL":
                    kw[name] = ng.p.Choice([False, True])
                else:
                    kw[name] = ng.p.Choice(list(spec["options"]))
            self._by_method[m] = ng.optimizers.NGOpt(
                parametrization=ng.p.Instrumentation(**kw),
                budget=budget,
            )
        self._asked = {}

    def ask(self):
        method = self.choose_method()
        cand = self._by_method[method].ask()
        params = dict(cand.kwargs)
        self._asked[
            (method, tuple(sorted(params.items())))
        ] = cand
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        bare = {
            k: v
            for k, v in params.items()
            if k in self.spaces[method]
        }
        cand = self._asked.pop(
            (method, tuple(sorted(bare.items()))), None
        )
        if cand is not None:
            self._by_method[method].tell(
                cand, score if math.isfinite(score) else 1e30
            )


class CMAESOptLib(HyperOptLib):
    """In-house separable CMA-ES (Ros & Hansen 2008) in the unit cube.

    Diagonal-covariance evolution strategy per method: generation-based
    (mean/step-size/path updates fire once ``popsize`` results arrive),
    but ask is always non-blocking - samples are i.i.d. draws from the
    current search distribution, so over-asking before tells simply
    enlarges the generation pool. Needs no external ``cmaes``
    package.
    """

    def __init__(
        self,
        methods,
        spaces,
        constants,
        seed=None,
        sigma0=0.3,
        popsize=None,
        **kwargs,
    ):
        super().__init__(methods, spaces, constants, seed=seed)
        self.state = {}
        for m in self.methods:
            d = len(self.spaces[m])
            lam = popsize or (4 + int(3 * math.log(max(d, 1))))
            mu = lam // 2
            # log-linear recombination weights
            w = [math.log(mu + 0.5) - math.log(i + 1) for i in range(mu)]
            tot = sum(w)
            w = [wi / tot for wi in w]
            mueff = 1.0 / sum(wi * wi for wi in w)
            n = max(d, 1)
            cs = (mueff + 2) / (n + mueff + 5)
            cc = (4 + mueff / n) / (n + 4 + 2 * mueff / n)
            c1 = 2 / ((n + 1.3) ** 2 + mueff)
            cmu = min(
                1 - c1,
                2 * (mueff - 2 + 1 / mueff) / ((n + 2) ** 2 + mueff),
            )
            # separable correction: scale learning rates up by (n+2)/3
            sep = (n + 2) / 3.0
            self.state[m] = {
                "d": d,
                "lam": lam,
                "w": w,
                "mueff": mueff,
                "cs": cs,
                "cc": cc,
                "c1": min(1.0, c1 * sep),
                "cmu": min(1.0, cmu * sep),
                "damps": 1
                + 2 * max(0.0, math.sqrt((mueff - 1) / (n + 1)) - 1)
                + cs,
                "chi_n": math.sqrt(n)
                * (1 - 1 / (4 * n) + 1 / (21 * n * n)),
                "mean": [0.5] * d,
                "sigma": sigma0,
                "C": [1.0] * d,  # diagonal covariance
                "ps": [0.0] * d,
                "pc": [0.0] * d,
                "gen": [],  # buffered (score, z) results
            }
        self.pending = {}

    def _dims(self, method):
        return sorted(self.spaces[method])

    def ask(self):
        method = self.choose_method()
        st = self.state[method]
        space = self.spaces[method]
        z = [self.rng.gauss(0, 1) for _ in range(st["d"])]
        vec = [
            min(
                max(
                    st["mean"][i]
                    + st["sigma"] * math.sqrt(st["C"][i]) * z[i],
                    0.0,
                ),
                1.0,
            )
            for i in range(st["d"])
        ]
        params = {
            name: _from_unit(space[name], u)
            for name, u in zip(self._dims(method), vec)
        }
        key = (method, tuple(sorted(params.items())))
        self.pending.setdefault(key, []).append(z)
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        st = self.state[method]
        if st["d"] == 0:
            return
        space = self.spaces[method]
        bare = {k: v for k, v in params.items() if k in space}
        key = (method, tuple(sorted(bare.items())))
        fifo = self.pending.get(key)
        if fifo:
            z = fifo.pop(0)
            if not fifo:
                del self.pending[key]
        else:
            # replayed/foreign result: back out z from the params
            vec = [
                _to_unit(space[name], bare[name])
                for name in self._dims(method)
            ]
            z = [
                (vec[i] - st["mean"][i])
                / (st["sigma"] * math.sqrt(st["C"][i]) or 1.0)
                for i in range(st["d"])
            ]
        if not math.isfinite(score):
            score = 1e300
        st["gen"].append((score, z))
        if len(st["gen"]) >= st["lam"]:
            self._update(st)

    def _update(self, st):
        d, w = st["d"], st["w"]
        mu = len(w)
        st["gen"].sort(key=lambda sz: sz[0])
        elite = [z for _, z in st["gen"][:mu]]
        st["gen"] = []
        # weighted mean step in z-space
        zw = [
            sum(w[k] * elite[k][i] for k in range(mu)) for i in range(d)
        ]
        # move the mean
        for i in range(d):
            st["mean"][i] = min(
                max(
                    st["mean"][i]
                    + st["sigma"] * math.sqrt(st["C"][i]) * zw[i],
                    0.0,
                ),
                1.0,
            )
        cs, cc = st["cs"], st["cc"]
        mueff = st["mueff"]
        # step-size path (z-space, isotropic)
        st["ps"] = [
            (1 - cs) * st["ps"][i]
            + math.sqrt(cs * (2 - cs) * mueff) * zw[i]
            for i in range(d)
        ]
        ps_norm = math.sqrt(sum(p * p for p in st["ps"]))
        # covariance path (x-space steps, normalized by sigma)
        hsig = (
            ps_norm / math.sqrt(1 - (1 - cs) ** 2) / st["chi_n"]
            < 1.4 + 2 / (d + 1)
        )
        st["pc"] = [
            (1 - cc) * st["pc"][i]
            + (
                math.sqrt(cc * (2 - cc) * mueff)
                * math.sqrt(st["C"][i])
                * zw[i]
                if hsig
                else 0.0
            )
            for i in range(d)
        ]
        c1, cmu = st["c1"], st["cmu"]
        for i in range(d):
            rank_mu = sum(
                w[k] * st["C"][i] * elite[k][i] ** 2 for k in range(mu)
            )
            st["C"][i] = max(
                (1 - c1 - cmu) * st["C"][i]
                + c1 * st["pc"][i] ** 2
                + cmu * rank_mu,
                1e-20,
            )
        st["sigma"] *= math.exp(
            (cs / st["damps"]) * (ps_norm / st["chi_n"] - 1)
        )
        st["sigma"] = min(max(st["sigma"], 1e-8), 2.0)


class SkoptOptLib(HyperOptLib):
    """scikit-optimize adapter (only if skopt is installed): one
    regressor-backed ``skopt.Optimizer`` per method."""

    def __init__(
        self,
        methods,
        spaces,
        constants,
        seed=None,
        sampler="et",
        sampler_opts=None,
        **kwargs,
    ):
        from skopt.optimizer import Optimizer
        from skopt.space import Categorical, Integer, Real

        super().__init__(methods, spaces, constants, seed=seed)

        def to_skopt_dim(name, spec):
            t = spec["type"]
            if t == "FLOAT":
                return Real(spec["min"], spec["max"], name=name)
            if t == "FLOAT_EXP":
                return Real(
                    spec["min"],
                    spec["max"],
                    prior="log-uniform",
                    name=name,
                )
            if t == "INT":
                return Integer(spec["min"], spec["max"], name=name)
            if t == "BOOL":
                return Categorical([False, True], name=name)
            return Categorical(list(spec["options"]), name=name)

        self._names = {m: sorted(spaces[m]) for m in self.methods}
        self._opts = {
            m: Optimizer(
                [
                    to_skopt_dim(name, spaces[m][name])
                    for name in self._names[m]
                ],
                base_estimator=sampler,
                random_state=(
                    self.rng.randrange(2**31) if seed is not None
                    else None
                ),
                **(sampler_opts or {}),
            )
            for m in self.methods
        }
        self._asked = {}

    def ask(self):
        import warnings

        method = self.choose_method()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", module="skopt")
            warnings.filterwarnings("ignore", module="sklearn")
            raw = self._opts[method].ask()
        params = dict(zip(self._names[method], raw))
        self._asked[(method, tuple(sorted(params.items())))] = raw
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        import warnings

        super().tell(method, params, score)
        bare = {
            k: v for k, v in params.items() if k in self.spaces[method]
        }
        raw = self._asked.pop(
            (method, tuple(sorted(bare.items()))), None
        )
        if raw is not None:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", module="skopt")
                warnings.filterwarnings("ignore", module="sklearn")
                self._opts[method].tell(
                    raw, score if math.isfinite(score) else 1e30
                )


register_hyper_optlib("cmaes", CMAESOptLib)


class DifferentialEvolutionOptLib(HyperOptLib):
    """DE/rand/1/bin per method, in the unit-mapped space.

    In-house sampler: a population of vectors, rand/1 mutation
    ``r0 + F*(r1 - r2)``, binomial crossover, greedy one-to-one
    selection, in this package's ask/tell protocol: rather than
    synchronous generations, each ask targets the next population slot
    round-robin and each tell resolves against its recorded slot
    (steady-state DE) — tolerant of out-of-order completion under
    parallel search.

    Parameters
    ----------
    popsize : int or "auto"
        Population size per method ("auto": ``max(8, min(4*d, 20))``).
    mutation : float
        Differential weight F.
    crossover : float
        Binomial crossover probability CR.
    mutation_decay : float
        Multiplied into F each time the target cursor wraps around the
        population (anneal toward exploitation).
    mutation_min : float
        Floor for the decayed F.
    """

    def __init__(
        self,
        methods,
        spaces,
        constants,
        seed=None,
        popsize="auto",
        mutation=0.7,
        crossover=0.8,
        mutation_decay=0.99,
        mutation_min=0.2,
    ):
        super().__init__(methods, spaces, constants, seed=seed)
        self.crossover = crossover
        self.mutation_decay = mutation_decay
        self.mutation_min = mutation_min
        self._names = {}
        self._pop = {}
        self._scores = {}
        self._pending = {}  # (method, params key) -> [(slot, vec)]
        self._cursor = {}
        self._seeded = {}
        self._mutation = {}
        for m in self.methods:
            names = sorted(spaces.get(m, ()))
            d = len(names)
            p = (
                max(8, min(4 * d, 20))
                if popsize == "auto"
                else max(int(popsize), 4)
            )
            self._names[m] = names
            self._pop[m] = [
                tuple(self.rng.random() for _ in names) for _ in range(p)
            ]
            self._scores[m] = [float("inf")] * p
            self._cursor[m] = 0
            self._seeded[m] = 0
            self._mutation[m] = mutation

    def _params_of(self, method, vec):
        space = self.spaces[method]
        return {
            name: _from_unit(space[name], u)
            for name, u in zip(self._names[method], vec)
        }

    def _key_of(self, method, params):
        space = self.spaces.get(method, {})
        return (
            method,
            tuple(sorted((k, v) for k, v in params.items() if k in space)),
        )

    def _propose(self, method, slot):
        pop = self._pop[method]
        f = self._mutation[method]
        others = [i for i in range(len(pop)) if i != slot]
        r0, r1, r2 = self.rng.sample(others, 3)
        target = pop[slot]
        d = len(target)
        j_rand = self.rng.randrange(d) if d else 0
        vec = []
        for k in range(d):
            if k == j_rand or self.rng.random() < self.crossover:
                v = pop[r0][k] + f * (pop[r1][k] - pop[r2][k])
                vec.append(min(max(v, 0.0), 1.0))
            else:
                vec.append(target[k])
        return tuple(vec)

    def ask(self):
        method = self.choose_method()
        pop = self._pop[method]
        if self._seeded[method] < len(pop):
            slot = self._seeded[method]
            self._seeded[method] += 1
            vec = pop[slot]
        else:
            slot = self._cursor[method]
            self._cursor[method] = (slot + 1) % len(pop)
            if self._cursor[method] == 0:
                self._mutation[method] = max(
                    self._mutation[method] * self.mutation_decay,
                    self.mutation_min,
                )
            vec = self._propose(method, slot)
        params = self._params_of(method, vec)
        key = self._key_of(method, params)
        self._pending.setdefault(key, []).append((slot, vec))
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        waiting = self._pending.get(self._key_of(method, params))
        if not waiting:
            return
        slot, vec = waiting.pop()
        if not waiting:
            del self._pending[self._key_of(method, params)]
        # greedy one-to-one selection
        if score < self._scores[method][slot]:
            self._scores[method][slot] = score
            self._pop[method][slot] = vec


class ParallelEvolutionOptLib(HyperOptLib):
    """Parallel (1+1)-ES workers with rank-assigned perturbation scales.

    In-house sampler: each of ``popsize`` workers hill-climbs its own
    solution; after every full cycle the per-worker Gaussian sigmas are reassigned by
    rank — the best worker gets ``sigma_min`` (exploit), the worst
    ``sigma_max`` (explore) — and workers stuck past ``patience``
    cycles are re-randomized. Steady-state / async-tolerant like
    :class:`DifferentialEvolutionOptLib`.
    """

    def __init__(
        self,
        methods,
        spaces,
        constants,
        seed=None,
        popsize=8,
        sigma_min=0.02,
        sigma_max=0.4,
        patience=20,
    ):
        super().__init__(methods, spaces, constants, seed=seed)
        self.popsize = max(int(popsize), 2)
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.patience = patience
        self._names = {m: sorted(spaces.get(m, ())) for m in methods}
        self._pop = {}
        self._scores = {}
        self._sigmas = {}
        self._stale = {}
        self._pending = {}
        self._cursor = {}
        self._seeded = {}
        for m in self.methods:
            names = self._names[m]
            self._pop[m] = [
                tuple(self.rng.random() for _ in names)
                for _ in range(self.popsize)
            ]
            self._scores[m] = [float("inf")] * self.popsize
            # log-spaced sigma ladder, one rung per worker
            self._sigmas[m] = [
                math.exp(
                    math.log(sigma_min)
                    + (math.log(sigma_max) - math.log(sigma_min))
                    * k
                    / max(self.popsize - 1, 1)
                )
                for k in range(self.popsize)
            ]
            self._stale[m] = [0] * self.popsize
            self._cursor[m] = 0
            self._seeded[m] = 0

    _params_of = DifferentialEvolutionOptLib._params_of
    _key_of = DifferentialEvolutionOptLib._key_of

    def _reassign_sigmas(self, method):
        """Best worker -> smallest sigma; re-randomize stuck workers."""
        scores = self._scores[method]
        order = sorted(range(self.popsize), key=lambda i: scores[i])
        ladder = sorted(self._sigmas[method])
        sig = [0.0] * self.popsize
        for rank, i in enumerate(order):
            sig[i] = ladder[rank]
        self._sigmas[method] = sig
        if self.patience:
            names = self._names[method]
            for i in range(self.popsize):
                if self._stale[method][i] >= self.patience:
                    self._pop[method][i] = tuple(
                        self.rng.random() for _ in names
                    )
                    self._scores[method][i] = float("inf")
                    self._stale[method][i] = 0

    def ask(self):
        method = self.choose_method()
        pop = self._pop[method]
        if self._seeded[method] < len(pop):
            slot = self._seeded[method]
            self._seeded[method] += 1
            vec = pop[slot]
        else:
            slot = self._cursor[method]
            self._cursor[method] = (slot + 1) % len(pop)
            if self._cursor[method] == 0:
                self._reassign_sigmas(method)
            s = self._sigmas[method][slot]
            vec = tuple(
                min(max(u + self.rng.gauss(0.0, s), 0.0), 1.0)
                for u in pop[slot]
            )
        params = self._params_of(method, vec)
        key = self._key_of(method, params)
        self._pending.setdefault(key, []).append((slot, vec))
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        waiting = self._pending.get(self._key_of(method, params))
        if not waiting:
            return
        slot, vec = waiting.pop()
        if not waiting:
            del self._pending[self._key_of(method, params)]
        if score < self._scores[method][slot]:
            self._scores[method][slot] = score
            self._pop[method][slot] = vec
            self._stale[method][slot] = 0
        else:
            self._stale[method][slot] += 1


register_hyper_optlib("de", DifferentialEvolutionOptLib)
register_hyper_optlib("pe", ParallelEvolutionOptLib)


class _ScipyStop(Exception):
    """Raised inside the objective to abort a scipy optimizer thread."""


class _ScipyWorker:
    """One scipy global optimizer run, inverted into ask/tell.

    The optimizer runs in a daemon thread; every objective evaluation
    posts its candidate to ``ask_q`` and blocks on ``tell_q``. The
    queues hold at most one item each, so claiming from ``ask_q``
    reserves the worker until its score is told back.
    """

    def __init__(self, optimizer, ndim, seed, kwargs):
        import queue
        import threading

        self.optimizer = optimizer
        self.ndim = ndim
        self.seed = seed
        self.kwargs = kwargs
        self.ask_q = queue.Queue(maxsize=1)
        self.tell_q = queue.Queue(maxsize=1)
        self.stop = threading.Event()
        self.done = False
        # True between claiming this worker's candidate and telling its
        # score back - a busy worker cannot produce another candidate
        self.busy = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _objective(self, x):
        if self.stop.is_set():
            raise _ScipyStop
        self.ask_q.put(tuple(float(v) for v in x))
        val = self.tell_q.get()
        if val is None or self.stop.is_set():
            raise _ScipyStop
        return float(val)

    def _run(self):
        try:
            from scipy import optimize

            fn = getattr(optimize, self.optimizer)
            bounds = [(0.0, 1.0)] * self.ndim
            kw = dict(self.kwargs)
            # stochastic optimizers take a seed; direct/shgo do not
            if self.optimizer in (
                "differential_evolution",
                "dual_annealing",
            ):
                kw.setdefault("seed", self.seed)
            fn(self._objective, bounds, **kw)
        except (_ScipyStop, Exception):  # noqa: BLE001 - contain worker
            pass
        finally:
            self.done = True

    def close(self):
        self.stop.set()
        try:
            self.tell_q.put_nowait(None)  # unblock a waiting objective
        except Exception:
            pass


class ScipyOptLib(HyperOptLib):
    """Gated adapter over scipy's gradient-free global optimizers.

    The callback-style scipy optimizers (``dual_annealing``,
    ``differential_evolution``, ``direct``, ``shgo``) are inverted into
    this package's ask/tell protocol by running each in a worker thread
    that trades candidates through size-1 queues. Several workers per
    method are spawned on demand so the driver's parallel pre-dispatch
    (ask-ask-...-tell-tell) never deadlocks on a single blocked
    optimizer.
    """

    def __init__(
        self,
        methods,
        spaces,
        constants,
        seed=None,
        optimizer="dual_annealing",
        max_workers=8,
        **scipy_kwargs,
    ):
        super().__init__(methods, spaces, constants, seed=seed)
        self.optimizer = optimizer
        self.max_workers = max_workers
        self.scipy_kwargs = scipy_kwargs
        self._names = {m: sorted(spaces.get(m, ())) for m in methods}
        self._workers = {m: [] for m in methods}
        self._pending = {}  # (method, params key) -> [(worker, vec)]

    _params_of = DifferentialEvolutionOptLib._params_of
    _key_of = DifferentialEvolutionOptLib._key_of

    def _claim_ask(self, method):
        """Claim a posted candidate from any live worker, waiting for a
        non-busy worker to produce one before spawning a new worker (so
        strict ask/tell alternation stays on ONE deterministic
        optimizer run regardless of thread scheduling)."""
        import queue as _q

        live = [w for w in self._workers[method] if not w.done]
        self._workers[method] = live
        for w in live:
            try:
                x = w.ask_q.get_nowait()
                w.busy = True
                return w, x
            except _q.Empty:
                continue
        # non-busy workers are computing their next candidate: wait
        for w in live:
            if w.busy or w.done:
                continue
            try:
                x = w.ask_q.get(timeout=10.0)
                w.busy = True
                return w, x
            except _q.Empty:
                continue  # optimizer likely converged mid-wait
        if len(live) < self.max_workers:
            w = _ScipyWorker(
                self.optimizer,
                len(self._names[method]),
                self.rng.randrange(2**31),
                self.scipy_kwargs,
            )
            self._workers[method].append(w)
            try:
                x = w.ask_q.get(timeout=10.0)
                w.busy = True
                return w, x
            except _q.Empty:
                pass
        return None, None

    def ask(self):
        method = self.choose_method()
        if not self._names[method]:
            return method, dict(self.constants.get(method, {}))
        worker, vec = self._claim_ask(method)
        if vec is None:
            # all workers busy/finished: fresh uniform sample (untracked)
            params = sample_uniform(self.spaces[method], self.rng)
            return method, {**self.constants.get(method, {}), **params}
        params = self._params_of(method, vec)
        key = self._key_of(method, params)
        self._pending.setdefault(key, []).append((worker, vec))
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        key = self._key_of(method, params)
        waiting = self._pending.get(key)
        if not waiting:
            return
        worker, _vec = waiting.pop()
        if not waiting:
            del self._pending[key]
        if not worker.done:
            worker.tell_q.put(
                score if math.isfinite(score) else 1e300
            )
        worker.busy = False

    def close(self):
        for ws in self._workers.values():
            for w in ws:
                w.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def register_optional_optlibs():
    try:
        import optuna  # noqa: F401

        register_hyper_optlib("optuna", OptunaOptLib)
    except ImportError:
        pass
    try:
        import nevergrad  # noqa: F401

        register_hyper_optlib("nevergrad", NevergradOptLib)
    except ImportError:
        pass
    try:
        import skopt  # noqa: F401

        register_hyper_optlib("skopt", SkoptOptLib)
    except ImportError:
        pass
    try:
        import scipy.optimize  # noqa: F401

        register_hyper_optlib("scipy", ScipyOptLib)
    except ImportError:
        pass
