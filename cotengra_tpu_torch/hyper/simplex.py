"""In-house Nelder-Mead and Subplex (Rowan 1990) hyper samplers
(counterpart of ``cotengra_tpu/hyper/simplex.py``).

When no external optlib (optuna, nevergrad) is installed, sampler quality
carries the hyper search, so a robust derivative-free optimizer matters.
Both samplers operate in the unit cube ``[0, 1]^d`` (the parameter
mapping of :func:`~cotengra_tpu_torch.hyper.optlibs._to_unit`).

Design notes (fully asynchronous ask/tell):

- :class:`NMCore` is a token-based Nelder-Mead state machine. ``ask``
  hands out points with tokens and returns ``None`` when the next NM
  move depends on results not yet told; the driver then issues filler
  points instead, so parallel pre-dispatch never deadlocks.
- :class:`SubplexSampler` runs NMCore instances over low-dimensional
  subspaces of the full parameter vector in cycles, rescaling the
  per-dimension step vector between cycles and restarting (alternately
  local/global) on stagnation. Subplex is markedly more robust than
  plain NM above ~5 dimensions, which is where our method spaces live.
"""

import math

from ..utils.misc import get_rng

# step-rescale clamp between subplex cycles (Rowan's omega)
OMEGA = 0.1


def _clip01(x):
    return 0.0 if x < 0.0 else (1.0 if x > 1.0 else x)


def _clipv(xs):
    return [_clip01(x) for x in xs]


class NMCore:
    """Asynchronous Nelder-Mead simplex over ``[0, 1]^ndim``.

    ``ask() -> (token, x) | None`` and ``tell(token, score)`` drive the
    classic reflect / expand / contract / shrink iteration, buffering
    out-of-order results. ``None`` from ask means the machine is blocked
    on outstanding evaluations.

    Convergence: Chebyshev simplex diameter below ``tol``, or below
    ``shrink_target`` times the initial diameter (the relative mode
    subplex relies on).
    """

    def __init__(
        self,
        center,
        scales,
        alpha=1.0,
        gamma=2.0,
        rho=0.5,
        sigma=0.5,
        adaptive=False,
        tol=0.01,
        shrink_target=None,
        inject_slack=1.5,
        inject_break_ratio=0.5,
    ):
        self.ndim = len(center)
        n = max(self.ndim, 1)
        if adaptive:
            # Gao & Han (2010) dimension-scaled coefficients
            alpha = 1.0
            gamma = 1.0 + 2.0 / n
            rho = 0.75 - 1.0 / (2.0 * n)
            sigma = 1.0 - 1.0 / n
        self.alpha, self.gamma, self.rho, self.sigma = (
            alpha, gamma, rho, sigma,
        )
        self.tol = tol
        self.shrink_target = shrink_target
        self.inject_slack = inject_slack
        self.inject_break_ratio = inject_break_ratio

        self.verts = []          # sorted best..worst once seeded
        self.scores = []
        self.best_x = None
        self.best_score = math.inf
        self.done = False

        self._next_token = 0
        self._ntold = 0
        self._out = []           # queued (token, x, tag) to hand out
        self._live = {}          # token -> (x, tag)
        self._ready = {}         # token -> (x, score, tag), buffered
        self._phase = "seed"
        self._mid = None         # centroid
        self._refl = None        # (x, score) of the reflected point
        self._inside = False     # contraction side
        self._inject = None      # deferred (x, score) replacement
        self._diam0 = None

        for k in range(self.ndim + 1):
            v = list(center)
            if k:
                v[k - 1] += scales[k - 1]
            self._queue(_clipv(v), "seed")

    # -- geometry ---------------------------------------------------

    def _queue(self, x, tag):
        t = self._next_token
        self._next_token += 1
        self._out.append((t, list(x), tag))
        self._live[t] = (list(x), tag)

    def _mix(self, a, b, w):
        """a + w * (b - a), clipped into the cube."""
        return _clipv(
            [ai + w * (bi - ai) for ai, bi in zip(a, b)]
        )

    def _center_face(self):
        m = len(self.verts) - 1
        return [
            sum(v[d] for v in self.verts[:-1]) / m
            for d in range(self.ndim)
        ]

    def _diameter(self):
        diam = 0.0
        for i, vi in enumerate(self.verts):
            for vj in self.verts[i + 1:]:
                d = max(abs(a - b) for a, b in zip(vi, vj))
                if d > diam:
                    diam = d
        return diam

    def _collapsed(self):
        d = self._diameter()
        if d < self.tol:
            return True
        return (
            self.shrink_target is not None
            and self._diam0 is not None
            and d < self.shrink_target * self._diam0
        )

    def _resort(self):
        pairs = sorted(
            zip(self.scores, self.verts), key=lambda p: p[0]
        )
        self.scores = [s for s, _ in pairs]
        self.verts = [list(v) for _, v in pairs]

    # -- state machine ----------------------------------------------

    def _take(self, tag, want_all=False):
        """Pop buffered results with this tag (token order)."""
        toks = sorted(
            t for t, r in self._ready.items() if r[2] == tag
        )
        if want_all is not False and len(toks) < want_all:
            return None
        if not toks:
            return None
        if want_all is False:
            toks = toks[:1]
        out = [self._ready.pop(t)[:2] for t in toks]
        return out if want_all is not False else out[0]

    def _advance(self):
        if self._phase == "seed":
            got = self._take("seed", want_all=self.ndim + 1)
            if got is None:
                return
            self.verts = [list(x) for x, _ in got]
            self.scores = [s for _, s in got]
            self._resort()
            self._diam0 = max(self._diameter(), self.tol)
            self._iterate()
        elif self._phase == "reflect":
            got = self._take("reflect")
            if got is None:
                return
            x, s = got
            self._refl = (x, s)
            if self.scores[0] <= s < self.scores[-2]:
                # middling improvement: accept, next iteration
                self.verts[-1], self.scores[-1] = list(x), s
                self._resort()
                self._iterate()
            elif s < self.scores[0]:
                # new best: probe further along the same direction
                self._phase = "expand"
                self._queue(
                    self._mix(self._mid, x, self.gamma), "expand"
                )
            else:
                # poor: pull toward the centroid, from whichever of
                # reflected/worst is better
                self._inside = s >= self.scores[-1]
                anchor = self.verts[-1] if self._inside else x
                self._phase = "contract"
                self._queue(
                    self._mix(self._mid, anchor, self.rho), "contract"
                )
        elif self._phase == "expand":
            got = self._take("expand")
            if got is None:
                return
            x, s = got
            rx, rs = self._refl
            if s < rs:
                self.verts[-1], self.scores[-1] = list(x), s
            else:
                self.verts[-1], self.scores[-1] = list(rx), rs
            self._resort()
            self._iterate()
        elif self._phase == "contract":
            got = self._take("contract")
            if got is None:
                return
            x, s = got
            bar = (
                self.scores[-1] if self._inside else self._refl[1]
            )
            if s < bar:
                self.verts[-1], self.scores[-1] = list(x), s
                self._resort()
                self._iterate()
            else:
                # simplex is fighting the landscape: shrink it all
                # toward the best vertex
                self._phase = "shrink"
                for v in self.verts[1:]:
                    self._queue(
                        self._mix(self.verts[0], v, self.sigma),
                        "shrink",
                    )
        elif self._phase == "shrink":
            got = self._take("shrink", want_all=len(self.verts) - 1)
            if got is None:
                return
            for k, (x, s) in enumerate(got):
                self.verts[k + 1] = list(x)
                self.scores[k + 1] = s
            self._resort()
            self._iterate()

    def _iterate(self):
        """Start a fresh reflect step (applying any deferred injection,
        checking convergence first)."""
        if self._inject is not None:
            x, s = self._inject
            self._inject = None
            self.verts[-1], self.scores[-1] = list(x), s
            self._resort()
        if self._collapsed():
            self.done = True
            return
        self._mid = self._center_face()
        self._phase = "reflect"
        # reflection of the worst vertex through the opposite face
        self._queue(
            self._mix(self._mid, self.verts[-1], -self.alpha),
            "reflect",
        )

    # -- public -----------------------------------------------------

    def ask(self):
        if self.done:
            return None
        self._advance()
        if self._out:
            t, x, _ = self._out.pop(0)
            return t, x
        return None

    def tell(self, token, score):
        self._ntold += 1
        x, tag = self._live.pop(token, (None, None))
        if x is not None and score < self.best_score:
            self.best_score = score
            self.best_x = list(x)
        if tag is None:
            return  # stale token from a replaced core
        self._ready[token] = (list(x), score, tag)
        self._advance()

    def offer(self, x, score):
        """Offer an externally-evaluated point (filler / exploration)
        for deferred injection over the worst vertex.

        Accepted only once seeded, when it beats the current worst and
        any already-pending injection, and when it would not inflate the
        simplex beyond ``inject_slack`` times its diameter. A rejected
        far-away point that is dramatically better than the incumbent
        (score below ``inject_break_ratio * best``) instead flags
        convergence so the caller restarts around the better region.
        """
        if self.done or self._phase == "seed" or not self.scores:
            return False
        if score >= self.scores[-1]:
            return False
        if self._inject is not None and score >= self._inject[1]:
            return False
        lim = self._diameter() * self.inject_slack
        for v in self.verts[:-1]:
            if max(abs(a - b) for a, b in zip(x, v)) > lim:
                if (
                    self._ntold > self.ndim
                    and score
                    < self.inject_break_ratio * self.best_score
                ):
                    self.done = True
                return False
        self._inject = (list(x), score)
        return True


def lhs_points(ndim, n, rng):
    """n latin-hypercube points in the unit cube."""
    cols = []
    for _ in range(ndim):
        qs = [(k + rng.random()) / n for k in range(n)]
        rng.shuffle(qs)
        cols.append(qs)
    return [[cols[d][k] for d in range(ndim)] for k in range(n)]


class SubplexSampler:
    """Subplex search over ``[0, 1]^ndim`` with async ask/tell.

    ``ask() -> (token, x)`` always returns a point: an LHS warmup point,
    an NM-directed point for the active subspace, an exploration point,
    or a gaussian filler around the best known point when the sub-NM is
    blocked. ``tell(token, score)`` feeds results back.
    """

    def __init__(
        self,
        ndim,
        seed=None,
        initial_scale=0.3,
        nsmin=2,
        nsmax=5,
        partition="greedy",
        psi=0.25,
        tol=0.01,
        filler_scale=0.15,
        n_warmup=None,
        patience="auto",
        explore_prob=0.05,
        adaptive=False,
        inject_slack=1.5,
        inject_break_ratio=0.5,
    ):
        self.ndim = ndim
        self.rng = get_rng(seed)
        self.initial_scale = initial_scale
        self.nsmin = min(nsmin, max(ndim, 1))
        self.nsmax = min(nsmax, max(ndim, 1))
        self.partition = partition
        self.psi = psi
        self.tol = tol
        self.filler_scale = filler_scale
        self.explore_prob = explore_prob
        self.adaptive = adaptive
        self.inject_slack = inject_slack
        self.inject_break_ratio = inject_break_ratio

        if patience == "auto":
            nsub = max(
                1, -(-ndim // self.nsmax) if self.nsmax else 1
            )
            patience = max(3, nsub)
        self.patience = patience

        self.x = [0.5] * ndim
        self.step = [initial_scale] * ndim
        self.best_x = None
        self.best_score = math.inf
        self.nrestarts = 0
        self.stagnant_restarts = 0
        self.flat_cycles = 0

        self._next_token = 0
        self._live = {}  # token -> ("warm"|"free"|"nm", coreid, coretok, x)

        if n_warmup is None:
            n_warmup = 2 * ndim
        self._warm = (
            lhs_points(ndim, n_warmup, self.rng) if (
                ndim and n_warmup
            ) else []
        )
        self._warm_open = 0
        self._warming = bool(self._warm)

        self._subspaces = None
        self._isub = 0
        self._dims = None
        self._core = None
        self._coreid = -1
        self._x0 = None
        self._step0 = None
        self._best0 = math.inf

    # -- partitioning -----------------------------------------------

    def split_dims(self):
        """Partition dims (sorted by |step| descending) into subspaces
        of size nsmin..nsmax; ``greedy`` takes maximal equal chunks,
        ``goodness`` uses Rowan's sharpest-drop heuristic."""
        order = sorted(
            range(self.ndim),
            key=lambda d: abs(self.step[d]),
            reverse=True,
        )
        mags = [abs(self.step[d]) for d in order]
        subs = []
        i = 0
        while i < len(order):
            rest = len(order) - i
            if rest <= self.nsmax:
                subs.append(order[i:])
                break
            if self.partition == "goodness":
                size = self._goodness_cut(mags, i)
            else:
                size = self.nsmax
                if 0 < rest - size < self.nsmin:
                    size = rest - self.nsmin
            subs.append(order[i:i + size])
            i += size
        self._subspaces = subs

    def _goodness_cut(self, mags, start):
        rest = len(mags) - start
        tot = sum(mags[start:])
        run = 0.0
        best_g, best_n = -math.inf, self.nsmin
        for k in range(min(self.nsmax, rest)):
            run += mags[start + k]
            n = k + 1
            left = rest - n
            if n < self.nsmin or (left and left < self.nsmin):
                continue
            g = run / n - ((tot - run) / left if left else 0.0)
            if g > best_g:
                best_g, best_n = g, n
        return best_n

    # -- cycle machinery --------------------------------------------

    def _open_cycle(self):
        self._x0 = list(self.x)
        self._step0 = list(self.step)
        self._best0 = self.best_score
        self.split_dims()
        self._isub = 0
        self._open_sub()

    def _open_sub(self):
        self._dims = self._subspaces[self._isub]
        self._coreid += 1
        self._core = NMCore(
            center=[self.x[d] for d in self._dims],
            scales=[self.step[d] for d in self._dims],
            adaptive=self.adaptive,
            tol=self.tol,
            shrink_target=self.psi,
            inject_slack=self.inject_slack,
            inject_break_ratio=self.inject_break_ratio,
        )

    def _close_sub(self):
        if self._core.best_x is not None:
            for i, d in enumerate(self._dims):
                self.x[d] = self._core.best_x[i]
        self._isub += 1
        if self._isub < len(self._subspaces):
            self._open_sub()
        else:
            self._close_cycle()

    def _rescale_steps(self):
        dx = [a - b for a, b in zip(self.x, self._x0)]
        if len(self._subspaces) > 1:
            denom = sum(abs(s) for s in self._step0)
            fac = (
                sum(abs(d) for d in dx) / denom if denom else 1.0
            )
            fac = min(max(fac, OMEGA), 1.0 / OMEGA)
        else:
            fac = self.psi
        for d in range(self.ndim):
            mag = abs(self._step0[d]) * fac
            if mag == 0.0:
                mag = self.initial_scale * fac
            mag = max(mag, self.tol)
            if dx[d] > 0.0:
                self.step[d] = mag
            elif dx[d] < 0.0:
                self.step[d] = -mag
            else:
                # keep probing, flipping the direction
                self.step[d] = (
                    mag if self._step0[d] < 0.0 else -mag
                )

    def _settled(self):
        """NLopt-style relative convergence over the whole cycle."""
        if self._x0 is None:
            return False
        for d in range(self.ndim):
            ref = max(abs(self.x[d]), 1.0)
            moved = abs(self.x[d] - self._x0[d]) / ref
            poked = abs(self.step[d]) * self.psi / ref
            if max(moved, poked) > self.tol:
                return False
        return True

    def _close_cycle(self):
        if self.best_score < self._best0:
            self.flat_cycles = 0
        else:
            self.flat_cycles += 1
        self._rescale_steps()
        stale = (
            self.patience is not None
            and self.flat_cycles >= self.patience
        )
        if self._settled() or stale:
            # alternate local jitter / global re-expansion
            self._restart(
                "local" if self.stagnant_restarts % 2 == 0
                else "global"
            )
        else:
            self._wipe_cycle()

    def _wipe_cycle(self):
        self._subspaces = None
        self._isub = 0
        self._dims = None
        self._core = None
        self._x0 = None
        self._step0 = None
        self._best0 = self.best_score

    def _restart(self, mode):
        if mode == "global":
            self.x = [self.rng.random() for _ in range(self.ndim)]
            self.step = [self.initial_scale] * self.ndim
        else:
            at = self.best_x if self.best_x is not None else self.x
            self.x = [
                _clip01(
                    self.rng.gauss(
                        xi, max(self.psi * abs(si), self.tol)
                    )
                )
                for xi, si in zip(at, self.step)
            ]
            self.step = [
                math.copysign(
                    max(abs(s) * self.psi, self.tol), s
                ) if s else self.initial_scale * self.psi
                for s in self.step
            ]
        self.nrestarts += 1
        self.stagnant_restarts += 1
        self._wipe_cycle()

    # -- public -----------------------------------------------------

    def _issue(self, kind, coreid, coretok, x):
        t = self._next_token
        self._next_token += 1
        self._live[t] = (kind, coreid, coretok, list(x))
        return t, x

    def _filler(self):
        at = self.best_x if self.best_x is not None else self.x
        scale = self.filler_scale
        if self._core is not None and not self._core.done:
            big = max((abs(s) for s in self.step), default=0.0)
            scale = max(0.5 * big, scale)
        return [
            _clip01(self.rng.gauss(c, scale)) for c in at
        ]

    def ask(self):
        if self.ndim == 0:
            return self._issue("free", None, None, [])
        if self._warming:
            if self._warm:
                x = self._warm.pop()
                self._warm_open += 1
                return self._issue("warm", None, None, x)
            return self._issue("free", None, None, self._filler())
        # stagnation widens exploration
        p = self.explore_prob + 0.05 * self.flat_cycles
        if p > 0 and self.rng.random() < p:
            x = [self.rng.random() for _ in range(self.ndim)]
            return self._issue("free", None, None, x)
        if self._core is None:
            self._open_cycle()
        got = self._core.ask()
        if got is not None:
            tok, sub = got
            full = list(self.x)
            for i, d in enumerate(self._dims):
                full[d] = sub[i]
            return self._issue("nm", self._coreid, tok, full)
        return self._issue("free", None, None, self._filler())

    def tell(self, token, score):
        kind, coreid, coretok, x = self._live.pop(
            token, ("free", None, None, None)
        )
        if score < self.best_score:
            self.best_score = score
            if x is not None:
                self.best_x = list(x)
            self.flat_cycles = 0
            self.stagnant_restarts = 0
        if kind == "warm":
            self._warm_open -= 1
            if self._warm_open <= 0 and not self._warm:
                if self.best_x is not None:
                    self.x = list(self.best_x)
                self._warming = False
            return
        if (
            kind == "free"
            and x is not None
            and self._core is not None
            and not self._core.done
            and self._dims is not None
        ):
            self._core.offer(
                [x[d] for d in self._dims], score
            )
        if kind != "nm" or coretok is None:
            return
        if (
            self._core is not None
            and self._coreid == coreid
            and not self._core.done
        ):
            self._core.tell(coretok, score)
            if self._core.done:
                self._close_sub()
