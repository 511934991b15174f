"""ctypes bindings of the port's native planning library (``kernels.cpp``).

The library is host C++: greedy search, batched random-greedy, the
optimal bitmask DP, the compressed (chi-capped) hypergraph replay and
the multilevel hypergraph partitioner (``ctg_partition``). It is the
port's own copy of the JAX package's ``ops/native`` with the same C ABI
and arithmetic, so that a seeded call returns exactly the reference's
result. ``ops/_build.py`` compiles it with ``g++`` at first use into
``build/cotengra_tpu_torch/``; where that fails the error is kept
(:func:`build_error`), the path finders' ``accel="auto"`` runs their
pure-Python versions and ``accel=True`` raises it.

ctypes releases the interpreter lock for the length of each call, so
native trials on a thread pool overlap.
"""

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "kernels.cpp"

_MINIMIZE_CODES = {
    "flops": 0,
    "max": 1,
    "size": 2,
    "write": 3,
    "combo": 4,
    "limit": 5,
}


def _declare(lib):
    i32p = ctypes.POINTER(ctypes.c_int)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.ctg_optimize_greedy.restype = ctypes.c_int
    lib.ctg_optimize_greedy.argtypes = [
        ctypes.c_int, i32p, i32p, ctypes.c_int, f64p, i32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, i32p,
    ]
    lib.ctg_optimize_random_greedy.restype = ctypes.c_int
    lib.ctg_optimize_random_greedy.argtypes = [
        ctypes.c_int, i32p, i32p, ctypes.c_int, f64p, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        i32p, f64p,
    ]
    lib.ctg_optimize_optimal.restype = ctypes.c_int
    lib.ctg_optimize_optimal.argtypes = [
        ctypes.c_int, i32p, i32p, ctypes.c_int, f64p, i32p, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, i32p,
    ]
    lib.ctg_compressed_stats.restype = ctypes.c_int
    lib.ctg_compressed_stats.argtypes = [
        ctypes.c_int, i32p, i32p, ctypes.c_int, f64p, i32p, ctypes.c_int,
        i32p, ctypes.c_int, ctypes.c_double, ctypes.c_int, f64p,
    ]
    lib.ctg_partition.restype = ctypes.c_int
    lib.ctg_partition.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, f64p, f64p,
        ctypes.c_int, ctypes.c_double, ctypes.c_uint64, i32p,
    ]
    return lib


@functools.lru_cache(maxsize=None)
def _load():
    """``(library, None)``, or ``(None, the exception)`` where the
    library does not build or load; tried once per process."""
    from .._build import build_host_library

    try:
        return _declare(ctypes.CDLL(str(build_host_library(_SRC)))), None
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        return None, exc


def is_available():
    return _load()[0] is not None


def build_error():
    """Why the library is unavailable (``None`` where it loaded)."""
    return _load()[1]


def library():
    """The loaded library; raises its build error where it is
    unavailable."""
    lib, err = _load()
    if lib is None:
        raise RuntimeError(
            f"the native planning library is unavailable: {err}"
        ) from err
    return lib


def _marshal(inputs, output, size_dict):
    indmap = {}
    flat = []
    offsets = [0]
    for term in inputs:
        for ind in term:
            ix = indmap.get(ind)
            if ix is None:
                ix = indmap[ind] = len(indmap)
            flat.append(ix)
        offsets.append(len(flat))
    sizes = np.empty(max(len(indmap), 1), dtype=np.float64)
    for ind, ix in indmap.items():
        sizes[ix] = float(size_dict[ind])
    out = np.array(
        [indmap[ind] for ind in output if ind in indmap], dtype=np.int32
    )
    return (
        np.array(offsets, dtype=np.int32),
        np.array(flat, dtype=np.int32) if flat else np.zeros(1, np.int32),
        sizes,
        out,
    )


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _decode_path(buf, nsteps):
    path = []
    for s in range(nsteps):
        i, j = int(buf[2 * s]), int(buf[2 * s + 1])
        path.append((i,) if j < 0 else (i, j))
    return path


def _seed_to_int(seed):
    """The library's 64-bit seed: an int masked to 64 bits, a draw from a
    ``random.Random``, or 8 bytes of ``os.urandom`` for ``None``."""
    if seed is None:
        return int.from_bytes(os.urandom(8), "little")
    if isinstance(seed, int):
        return seed & (2**64 - 1)
    return seed.randrange(2**64)


def _as_path(path, n, use_ssa):
    if use_ssa:
        return path
    from ...tree import ssa_to_linear

    return ssa_to_linear(path, n)


def optimize_greedy(
    inputs,
    output,
    size_dict,
    costmod=1.0,
    temperature=0.0,
    max_neighbors=16,
    simplify=True,
    seed=None,
    use_ssa=False,
):
    lib = library()
    offsets, flat, sizes, out = _marshal(inputs, output, size_dict)
    n = len(inputs)
    buf = np.empty(2 * (4 * n + 16), dtype=np.int32)
    nsteps = lib.ctg_optimize_greedy(
        n, _i32p(offsets), _i32p(flat), len(sizes), _f64p(sizes),
        _i32p(out), len(out), float(costmod), float(temperature),
        int(max_neighbors), int(bool(simplify)), _seed_to_int(seed),
        _i32p(buf),
    )
    if nsteps < 0:
        raise RuntimeError("native optimize_greedy failed")
    return _as_path(_decode_path(buf, nsteps), n, use_ssa)


def optimize_random_greedy_track_flops(
    inputs,
    output,
    size_dict,
    ntrials=1,
    costmod=(0.1, 4.0),
    temperature=(0.001, 1.0),
    max_neighbors=16,
    simplify=True,
    seed=None,
    use_ssa=False,
):
    """``(path, log10 flops)`` of the best of ``ntrials`` greedy trials."""
    lib = library()
    if isinstance(costmod, (int, float)):
        costmod = (costmod, costmod)
    if isinstance(temperature, (int, float)):
        temperature = (temperature, temperature)
    offsets, flat, sizes, out = _marshal(inputs, output, size_dict)
    n = len(inputs)
    buf = np.empty(2 * (4 * n + 16), dtype=np.int32)
    lf = ctypes.c_double(0.0)
    nsteps = lib.ctg_optimize_random_greedy(
        n, _i32p(offsets), _i32p(flat), len(sizes), _f64p(sizes),
        _i32p(out), len(out), int(ntrials), float(costmod[0]),
        float(costmod[1]), float(temperature[0]), float(temperature[1]),
        int(max_neighbors), int(bool(simplify)), _seed_to_int(seed),
        _i32p(buf), ctypes.byref(lf),
    )
    if nsteps < 0:
        raise RuntimeError("native optimize_random_greedy failed")
    return _as_path(_decode_path(buf, nsteps), n, use_ssa), lf.value


def optimize_optimal(
    inputs,
    output,
    size_dict,
    minimize="flops",
    cost_cap=2,
    search_outer=False,
    simplify=True,
    use_ssa=False,
):
    """The optimal DP; a component past the bitmask's 62 terms falls back
    to the pure-Python DP of ``pathfinders/basic.py``."""
    lib = library()
    name, _, fstr = str(minimize).partition("-")
    factor = float(fstr) if fstr else 64.0
    code = _MINIMIZE_CODES.get(name)
    if code is None:
        raise ValueError(f"Unknown minimize {minimize!r}")
    offsets, flat, sizes, out = _marshal(inputs, output, size_dict)
    n = len(inputs)
    buf = np.empty(2 * (4 * n + 16), dtype=np.int32)
    nsteps = lib.ctg_optimize_optimal(
        n, _i32p(offsets), _i32p(flat), len(sizes), _f64p(sizes),
        _i32p(out), len(out), code, factor, float(cost_cap),
        int(bool(search_outer)), int(bool(simplify)), _i32p(buf),
    )
    if nsteps == -2:
        from ...pathfinders import basic

        return basic.optimize_optimal(
            inputs, output, size_dict, minimize=minimize,
            cost_cap=cost_cap, search_outer=search_outer,
            simplify=simplify, use_ssa=use_ssa, accel=False,
        )
    if nsteps < 0:
        raise RuntimeError("native optimize_optimal failed")
    return _as_path(_decode_path(buf, nsteps), n, use_ssa)


def compressed_stats(
    inputs, output, size_dict, order_pairs, chi, compress_late=False
):
    """Replay ``order_pairs`` (hypergraph-node id pairs; leaves are
    0..N-1, step k makes node N+k) with chi-capped compression, returning
    ``(flops, write, max_size, peak_size)``.
    """
    lib = library()
    offsets, flat, sizes, out = _marshal(inputs, output, size_dict)
    pairs = np.asarray(order_pairs, dtype=np.int32).reshape(-1)
    out4 = np.zeros(4, dtype=np.float64)
    status = lib.ctg_compressed_stats(
        len(inputs), _i32p(offsets), _i32p(flat), len(sizes),
        _f64p(sizes), _i32p(out), len(out), _i32p(pairs),
        len(pairs) // 2, float(chi), int(bool(compress_late)),
        _f64p(out4),
    )
    if status != 0:
        raise RuntimeError("native compressed_stats failed")
    return tuple(out4)


def partition(
    eptr, pins, edge_weights, node_weights, parts, imbalance, seed
):
    """Multilevel hypergraph partition (``ctg_partition``): heavy-
    connectivity-matching coarsening, greedy-grown initial bisection,
    2-way hyperedge FM, recursive k-way. Returns an int membership array
    of length ``len(node_weights)``; raises where the library is
    unavailable."""
    lib = library()
    eptr = np.ascontiguousarray(eptr, dtype=np.int64)
    pins = np.ascontiguousarray(pins, dtype=np.int32)
    ew = np.ascontiguousarray(edge_weights, dtype=np.float64)
    nw = np.ascontiguousarray(node_weights, dtype=np.float64)
    n = len(nw)
    out = np.empty(n, dtype=np.int32)
    status = lib.ctg_partition(
        n,
        len(ew),
        eptr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        _i32p(pins),
        _f64p(ew),
        _f64p(nw),
        int(parts),
        float(imbalance),
        ctypes.c_uint64(int(seed) & (2**64 - 1)),
        _i32p(out),
    )
    if status != 0:
        raise RuntimeError("native ctg_partition failed")
    return out
