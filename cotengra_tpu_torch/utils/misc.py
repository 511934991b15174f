"""Small shared primitives (counterpart of ``cotengra_tpu/utils/misc.py``:
``prod``, ``compute_size_by_dict``, ``get_rng``,
``GumbelBatchedGenerator``, the planner's ``BadTrial``, ``MaxCounter``
and ``DiskDict``, and ``interleave`` and ``unique``)."""

import collections
import itertools
import math
import os
import pickle
import random


def prod(it):
    p = 1
    for x in it:
        p *= x
    return p


def compute_size_by_dict(inds, size_dict):
    """Product of the sizes of ``inds`` (an iterable of index labels)."""
    p = 1
    for ix in inds:
        p *= size_dict[ix]
    return p


def get_rng(seed=None):
    """Get a ``random.Random`` instance: pass through if already one, seed a
    new one with an int or None.
    """
    if isinstance(seed, random.Random):
        return seed
    return random.Random(seed)


class GumbelBatchedGenerator:
    """Cheap Gumbel noise for the greedy search's hot loop: exponential
    variates drawn 512 at a time and transformed, then handed out from
    the end of the batch. The same seed draws the same numbers as the
    reference's generator."""

    def __init__(self, rng=None):
        self.rng = get_rng(rng)
        self._buf = []

    def __call__(self):
        if not self._buf:
            expo = self.rng.expovariate
            self._buf = [-math.log(expo(1.0)) for _ in range(512)]
        return self._buf.pop()


class BadTrial(Exception):
    """Raise in a trial function to flag the trial as infeasible - the
    hyper-optimizer records an inf score but keeps the sampler consistent.
    """


class MaxCounter:
    """A multiset that efficiently tracks its maximum element under adds and
    discards (used for incremental max-size tracking on trees).
    """

    __slots__ = ("_counts", "_max_element")

    def __init__(self, it=None):
        self._counts = collections.Counter(it)
        self._max_element = max(self._counts) if self._counts else None

    def copy(self):
        new = MaxCounter.__new__(MaxCounter)
        new._counts = self._counts.copy()
        new._max_element = self._max_element
        return new

    def add(self, x):
        self._counts[x] += 1
        if self._max_element is None or x > self._max_element:
            self._max_element = x

    def discard(self, x):
        cnt = self._counts[x] - 1
        if cnt:
            self._counts[x] = cnt
        else:
            del self._counts[x]
            if x == self._max_element:
                self._max_element = max(self._counts) if self._counts else None

    def max(self):
        return self._max_element

    def __len__(self):
        return sum(self._counts.values())

    def __repr__(self):
        return f"<MaxCounter(max={self._max_element}, n={len(self)})>"


class DiskDict:
    """A simple directory-backed persistent mapping with an in-memory
    write-through cache. Keys must be strings; values anything picklable.

    If ``directory`` is None acts as a plain in-memory dict.
    """

    def __init__(self, directory=None, max_key_split=2):
        self._mem = {}
        self._directory = directory
        self._max_key_split = max_key_split
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def _path(self, key):
        # split long hash keys into subdirectories to avoid huge flat dirs
        key = str(key)
        parts = []
        for _ in range(self._max_key_split):
            if len(key) <= 2:
                break
            parts.append(key[:2])
            key = key[2:]
        parts.append(key)
        return os.path.join(self._directory, *parts)

    def clear(self):
        self._mem.clear()
        if self._directory is not None:
            import shutil

            shutil.rmtree(self._directory, ignore_errors=True)
            os.makedirs(self._directory, exist_ok=True)

    def cleanup(self, delete_dir=False):
        self._mem.clear()
        if delete_dir and self._directory is not None:
            import shutil

            shutil.rmtree(self._directory, ignore_errors=True)

    def __contains__(self, key):
        if key in self._mem:
            return True
        if self._directory is not None and os.path.exists(self._path(key)):
            return True
        return False

    def __getitem__(self, key):
        try:
            return self._mem[key]
        except KeyError:
            pass
        if self._directory is not None:
            path = self._path(key)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    val = pickle.load(f)
                self._mem[key] = val
                return val
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        self._mem[key] = value
        if self._directory is not None:
            path = self._path(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)

    def __delitem__(self, key):
        self._mem.pop(key, None)
        if self._directory is not None:
            path = self._path(key)
            if os.path.exists(path):
                os.remove(path)

    def __len__(self):
        if self._directory is None:
            return len(self._mem)
        n = 0
        for _, _, files in os.walk(self._directory):
            n += sum(1 for f in files if not f.endswith(".tmp"))
        return n


def interleave(*its):
    """Round-robin interleave iterables."""
    sentinel = object()
    for group in itertools.zip_longest(*its, fillvalue=sentinel):
        for x in group:
            if x is not sentinel:
                yield x


def unique(it):
    """Deduplicate preserving order."""
    return list(dict.fromkeys(it))
