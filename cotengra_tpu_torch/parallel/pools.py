"""Host-side pools for search parallelism (counterpart of
``cotengra_tpu/parallel/pools.py``).

The planning search (hyper-optimizer trials, random-greedy batches, forest
reconfiguration) is combinatorial CPU work and stays on the host. This
module is its pool plumbing: one ``parse_parallel_arg`` accepting
``False | True | int | "auto" | "threads[:N]" | "processes[:N]" |
"loky[:N]" | "dask[:N]" | "ray[:N]" | an executor``, cached pool
creation, ``submit`` and ``scatter``, and a worker-process guard that
keeps workers from starting pools of their own. loky, dask and ray are
imported only when asked for, and raise ``ImportError`` when missing.

A process forked after CUDA is initialised cannot use the card, and
forking such a process is unsafe: plan with ``parallel=False`` (or
threads) in a process that has touched the card. No execution goes
through here.
"""

import os

_IS_WORKER = False
_POOL_PID = None
_CACHED_POOLS = {}


def get_num_workers():
    """Default worker count: ``COTENGRA_NUM_WORKERS`` or cpu count."""
    env = os.environ.get("COTENGRA_NUM_WORKERS")
    if env:
        return int(env)
    return os.cpu_count() or 1


def _mark_worker():
    global _IS_WORKER
    _IS_WORKER = True


def is_worker_process():
    return _IS_WORKER


def _check_pid():
    """Invalidate cached pools after a fork."""
    global _POOL_PID
    pid = os.getpid()
    if _POOL_PID is None:
        _POOL_PID = pid
    elif _POOL_PID != pid:
        _CACHED_POOLS.clear()
        _POOL_PID = pid


def _make_process_pool(n):
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=n, initializer=_mark_worker
    )
    return pool


def _make_thread_pool(n):
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(max_workers=n)


def parse_parallel_arg(parallel):
    """Resolve a ``parallel`` argument into an executor pool or None.

    - ``False``/``None`` -> None (serial)
    - ``True`` / ``"auto"`` -> cached process pool with default workers
    - int -> cached process pool of that many workers
    - ``"threads"`` / ``"threads:N"`` -> cached thread pool
    - ``"processes"`` / ``"processes:N"`` -> cached process pool
    - ``"loky[:N]"`` -> reusable loky process pool (crash-tolerant)
    - ``"dask[:N]"`` / ``"ray[:N]"`` -> distributed executors (optional
      dependencies)
    - an object with ``submit`` -> used directly
    """
    if parallel is False or parallel is None:
        return None

    if is_worker_process():
        # never auto-create nested pools inside workers
        return None

    if parallel is True or parallel == "auto":
        # fork guard: if this process inherited another process's pool
        # state (PID mismatch), auto must NOT silently spin up a fresh
        # pool - that is how recursive pool explosions start. Explicit backend requests below
        # still work after the _check_pid cache invalidation.
        if _POOL_PID is not None and _POOL_PID != os.getpid():
            return None
        key = ("processes", get_num_workers())
    elif isinstance(parallel, int):
        key = ("processes", parallel)
    elif isinstance(parallel, str):
        name, _, nstr = parallel.partition(":")
        n = int(nstr) if nstr else get_num_workers()
        if name in ("threads", "thread"):
            key = ("threads", n)
        elif name in ("processes", "process", "concurrent.futures"):
            key = ("processes", n)
        elif name == "loky":
            return _get_loky_pool(n)
        elif name == "dask":
            return _get_dask_pool(n)
        elif name == "ray":
            return _get_ray_pool(n)
        else:
            raise ValueError(f"Unknown parallel backend {parallel!r}.")
    elif hasattr(parallel, "submit"):
        return parallel
    else:
        raise ValueError(f"Can't interpret parallel={parallel!r}.")

    _check_pid()
    try:
        pool = _CACHED_POOLS[key]
    except KeyError:
        kind, n = key
        if kind == "threads":
            pool = _make_thread_pool(n)
        else:
            pool = _make_process_pool(n)
        _CACHED_POOLS[key] = pool
    return pool


def set_parallel_backend(parallel):
    """Eagerly create and return the default pool."""
    return parse_parallel_arg(parallel)


def _get_loky_pool(n):
    """loky-backed reusable process pool: survives worker crashes and
    resizes in place. Imported from loky directly or via
    joblib's vendored copy."""
    try:
        from loky import get_reusable_executor
    except ImportError:
        try:
            from joblib.externals.loky import get_reusable_executor
        except ImportError as e:
            raise ImportError(
                "parallel='loky' requires loky or joblib"
            ) from e
    return get_reusable_executor(
        max_workers=n, initializer=_mark_worker
    )


def _get_dask_pool(n):
    """dask.distributed-backed executor (optional dependency): reuses an
    existing client or creates a local cluster."""
    try:
        from dask.distributed import Client, get_client
    except ImportError as e:
        raise ImportError(
            "parallel='dask' requires dask.distributed"
        ) from e
    try:
        client = get_client()
    except ValueError:
        import warnings

        warnings.warn("Creating a local dask cluster...")
        client = Client(n_workers=n, threads_per_worker=1)
    return client.get_executor()


def _get_ray_pool(n):
    """ray-backed executor (optional dependency): a minimal pool wrapper
    submitting remote functions."""
    try:
        import ray
    except ImportError as e:
        raise ImportError("parallel='ray' requires ray") from e
    if not ray.is_initialized():
        ray.init(num_cpus=n, ignore_reinit_error=True)

    class _RayFuture:
        def __init__(self, ref):
            self._ref = ref

        def result(self, timeout=None):
            import ray as _ray

            return _ray.get(self._ref, timeout=timeout)

        def cancel(self):
            import ray as _ray

            _ray.cancel(self._ref, force=False)

        def done(self):
            import ray as _ray

            ready, _ = _ray.wait([self._ref], timeout=0)
            return bool(ready)

    class _RayPool:
        _max_workers = n
        _remote_cache = {}

        def submit(self, fn, *args, **kwargs):
            rf = self._remote_cache.get(fn)
            if rf is None:
                rf = self._remote_cache[fn] = ray.remote(fn)
            return _RayFuture(rf.remote(*args, **kwargs))

        def scatter(self, data):
            return ray.put(data)

    return _RayPool()


def get_pool_size(pool):
    n = getattr(pool, "_max_workers", None)
    if n is None:
        n = get_num_workers()
    return n


def submit(pool, fn, *args, **kwargs):
    """Submit a job to any supported pool type."""
    return pool.submit(fn, *args, **kwargs)


def can_scatter(pool):
    """Whether the pool pre-scatters large objects (only distributed
    pools such as dask's and ray's do; local pools need not)."""
    return hasattr(pool, "scatter")


def scatter(pool, data):
    if can_scatter(pool):
        return pool.scatter(data)
    return data


def should_nest(pool):
    """Whether nested parallelism inside a trial is sensible (only for
    pools whose workers can themselves reach a scheduler)."""
    return False


def maybe_leave_pool(pool):
    """Hook for schedulers that let a worker secede (dask); a no-op for
    local pools."""
    return None


def maybe_rejoin_pool(pool, token):
    return None
