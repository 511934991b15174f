"""Declarative hyper-parameter spaces and samplers (counterpart of
``cotengra_tpu/hyper/space.py``).

A space is ``{param: {"type": "FLOAT"|"FLOAT_EXP"|"INT"|"STRING"|"BOOL",
"min": .., "max": .., "options": [..]}}``. Samplers provide the ask/tell
interface used by the hyper-optimizer driver; the in-house ones are
dependency-free, and the same seed and scores ask the same parameters as
the reference's.
"""

import math

from ..utils.misc import get_rng


def sample_uniform(space, rng):
    """Draw an independent uniform sample from a space."""
    params = {}
    for name, spec in space.items():
        t = spec["type"]
        if t == "FLOAT":
            params[name] = rng.uniform(spec["min"], spec["max"])
        elif t == "FLOAT_EXP":
            lo, hi = math.log(spec["min"]), math.log(spec["max"])
            params[name] = math.exp(rng.uniform(lo, hi))
        elif t == "INT":
            params[name] = rng.randint(spec["min"], spec["max"])
        elif t == "STRING":
            params[name] = rng.choice(spec["options"])
        elif t == "BOOL":
            params[name] = rng.random() < 0.5
        else:
            raise ValueError(f"Unknown param type {t}")
    return params


def _mutate_param(spec, value, rng, strength=0.3):
    t = spec["type"]
    if t == "FLOAT":
        lo, hi = spec["min"], spec["max"]
        value = value + rng.gauss(0, strength * (hi - lo))
        return min(max(value, lo), hi)
    if t == "FLOAT_EXP":
        lo, hi = math.log(spec["min"]), math.log(spec["max"])
        lv = math.log(max(value, 1e-300)) + rng.gauss(0, strength * (hi - lo))
        return math.exp(min(max(lv, lo), hi))
    if t == "INT":
        lo, hi = spec["min"], spec["max"]
        step = max(1, round(strength * (hi - lo)))
        value = value + rng.randint(-step, step)
        return min(max(value, lo), hi)
    if t == "STRING":
        if rng.random() < strength:
            return rng.choice(spec["options"])
        return value
    if t == "BOOL":
        if rng.random() < strength:
            return not value
        return value
    raise ValueError(t)


class HyperOptLib:
    """Base ask/tell sampler over (method, params)."""

    def __init__(self, methods, spaces, constants, seed=None):
        self.methods = list(methods)
        self.spaces = spaces  # method -> space dict
        self.constants = constants  # method -> fixed params
        self.rng = get_rng(seed)
        # per-method score history for bandit method selection
        self.history = {m: [] for m in self.methods}

    def choose_method(self):
        """LCB-style bandit: prefer methods with good best-scores, explore
        under-sampled ones.
        """
        if len(self.methods) == 1:
            return self.methods[0]
        total = sum(len(h) for h in self.history.values()) + 1
        best = None
        best_v = float("inf")
        for m in self.methods:
            h = self.history[m]
            if len(h) < 3:
                return m  # warmup
            mbest = min(h)
            explore = math.sqrt(2 * math.log(total) / len(h))
            v = mbest - explore
            if v < best_v:
                best_v = v
                best = m
        return best

    def ask(self):
        raise NotImplementedError

    def tell(self, method, params, score):
        self.history[method].append(score)


class RandomOptLib(HyperOptLib):
    """Uniform random search with a latin-hypercube-style stratified warmup
    for FLOAT params.
    """

    def __init__(self, methods, spaces, constants, seed=None, warmup=8):
        super().__init__(methods, spaces, constants, seed=seed)
        self._warmup_queues = {}
        for m in self.methods:
            self._warmup_queues[m] = self._make_lhs(m, warmup)

    def _make_lhs(self, method, n):
        space = self.spaces[method]
        cols = {}
        for name, spec in space.items():
            if spec["type"] in ("FLOAT", "FLOAT_EXP"):
                # stratified quantiles, shuffled
                qs = [(i + self.rng.random()) / n for i in range(n)]
                self.rng.shuffle(qs)
                cols[name] = qs
        samples = []
        for i in range(n):
            params = sample_uniform(space, self.rng)
            for name, qs in cols.items():
                spec = space[name]
                q = qs[i]
                if spec["type"] == "FLOAT":
                    params[name] = spec["min"] + q * (
                        spec["max"] - spec["min"]
                    )
                else:
                    lo, hi = math.log(spec["min"]), math.log(spec["max"])
                    params[name] = math.exp(lo + q * (hi - lo))
            samples.append(params)
        return samples

    def ask(self):
        method = self.choose_method()
        queue = self._warmup_queues.get(method)
        if queue:
            params = queue.pop()
        else:
            params = sample_uniform(self.spaces[method], self.rng)
        return method, {**self.constants.get(method, {}), **params}


class EvolutionOptLib(HyperOptLib):
    """Steady-state evolution strategy ('sses'): keep a
    small elite population per method; propose by mutating a random elite,
    occasionally sampling fresh.
    """

    def __init__(
        self,
        methods,
        spaces,
        constants,
        seed=None,
        popsize=8,
        fresh_rate=0.15,
        strength=0.3,
    ):
        super().__init__(methods, spaces, constants, seed=seed)
        self.popsize = popsize
        self.fresh_rate = fresh_rate
        self.strength = strength
        self.pop = {m: [] for m in self.methods}  # list of (score, params)

    def ask(self):
        method = self.choose_method()
        space = self.spaces[method]
        pop = self.pop[method]
        if len(pop) < max(3, self.popsize // 2) or (
            self.rng.random() < self.fresh_rate
        ):
            params = sample_uniform(space, self.rng)
        else:
            _, parent = pop[self.rng.randrange(len(pop))]
            params = {
                name: _mutate_param(
                    space[name], parent[name], self.rng, self.strength
                )
                for name in space
            }
        return method, {**self.constants.get(method, {}), **params}

    def tell(self, method, params, score):
        super().tell(method, params, score)
        if not math.isfinite(score):
            return
        space = self.spaces[method]
        bare = {k: v for k, v in params.items() if k in space}
        pop = self.pop[method]
        pop.append((score, bare))
        pop.sort(key=lambda sp: sp[0])
        del pop[self.popsize:]


_OPTLIB_REGISTRY = {}


def register_hyper_optlib(name, cls):
    _OPTLIB_REGISTRY[name] = cls


def get_optlib(name):
    if name == "auto":
        # preference ladder: optuna where installed, else the in-house
        # cmaes (then sbplx)
        for cand in ("optuna", "cmaes", "sbplx"):
            if cand in _OPTLIB_REGISTRY:
                name = cand
                break
    try:
        return _OPTLIB_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown optlib {name!r}; have {sorted(_OPTLIB_REGISTRY)}"
        ) from None


register_hyper_optlib("random", RandomOptLib)
register_hyper_optlib("sses", EvolutionOptLib)
register_hyper_optlib("evo", EvolutionOptLib)
