"""Global executor defaults (counterpart of ``cotengra_tpu/config.py``).

``contract_tree`` and the other entry points read ``implementation``
(``None`` = torch einsum / matmul steps; ``"pallas"`` = the fused
kernels where a step qualifies) and ``slice_batch`` from here when the
caller leaves them unset. The reference's ``precision`` key has no
counterpart: the port runs true float32 everywhere.
"""

import contextlib
import threading

_LOCAL = threading.local()

_DEFAULTS = {
    "implementation": None,
    "slice_batch": None,
}


def _state():
    try:
        return _LOCAL.state
    except AttributeError:
        _LOCAL.state = dict(_DEFAULTS)
        return _LOCAL.state


def get_default(key):
    return _state()[key]


def set_default(key, value):
    if key not in _DEFAULTS:
        raise KeyError(
            f"Unknown option {key!r}; have {sorted(_DEFAULTS)}"
        )
    _state()[key] = value


def get_default_implementation():
    return get_default("implementation")


def set_default_implementation(impl):
    """Set the default executor implementation: None (torch einsum /
    matmul steps) or ``"pallas"`` (the fused kernels where a step
    qualifies)."""
    set_default("implementation", impl)


@contextlib.contextmanager
def default_implementation(impl):
    """Context manager temporarily switching the executor implementation."""
    old = get_default("implementation")
    set_default("implementation", impl)
    try:
        yield
    finally:
        set_default("implementation", old)


@contextlib.contextmanager
def default_options(**kwargs):
    """Context manager temporarily overriding any executor defaults."""
    state = _state()
    old = {k: state[k] for k in kwargs}
    for k, v in kwargs.items():
        set_default(k, v)
    try:
        yield
    finally:
        state.update(old)
