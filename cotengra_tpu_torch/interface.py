"""The front end: ``einsum`` / ``array_contract`` / ``ncon`` drop-ins
with cached expressions (counterpart of ``cotengra_tpu/interface.py``).

- ``array_contract{,_path,_tree,_expression}`` over arbitrary hashable
  index labels;
- ``einsum{,_tree,_expression}`` over string equations (ellipses
  included) and interleaved arguments; ``ncon``;
- ``optimize=`` dispatch by type: a preset string (``presets.py``), a
  path optimizer or path function, an explicit path, or a
  ``ContractionTree``, which is used as it is, labels and all;
- three content-hash caches (paths, trees, expressions) keyed on the
  canonically relabelled contraction, so that repeated contractions
  reuse their plan; each expression's tree in turn caches its planned
  contractor (``ops/executor.py::_cached_full``), so that a repeated
  call costs only its host canonicalisation; an expression with
  constants keeps its own contractors, with the constant-only steps
  folded.

Entry points run on the card unless the caller passes ``device="cpu"``.
Where ``plane_dtype`` is not given it follows the inputs: float64 or
complex128 inputs run in float64, anything else in float32.
"""

import threading

import numpy as np
import torch

from ._device import resolve_device
from .convert import to_tensors
from .ops.executor import _defaults, make_full_contractor
from .tree import ContractionTree
from .utils.eqs import (
    canonicalize_inputs,
    eq_to_inputs_output,
    hash_contraction,
    parse_einsum_input,
)

_PRESETS = {}
_PRESETS_TREE = {}


def register_preset(preset, optimizer, optimizer_tree=None):
    """Register a preset name (or names): ``optimizer(inputs, output,
    size_dict)`` returns a path, ``optimizer_tree`` (optional) a
    ContractionTree directly."""
    if isinstance(preset, str):
        preset = (preset,)
    for p in preset:
        if optimizer is not None:
            _PRESETS[p] = optimizer
        if optimizer_tree is not None:
            _PRESETS_TREE[p] = optimizer_tree


def list_presets():
    return sorted(set(_PRESETS) | set(_PRESETS_TREE))


def preset_to_optimizer(preset):
    """The path function registered under ``preset``."""
    try:
        return _PRESETS[preset]
    except KeyError:
        raise KeyError(
            f"Unknown optimize preset {preset!r}, "
            f"valid presets: {list_presets()}"
        ) from None


# -- optimize dispatch ----------------------------------------------------


def _is_path(optimize):
    return (
        isinstance(optimize, (tuple, list))
        and len(optimize) > 0
        and isinstance(optimize[0], (tuple, list))
    )


def find_tree(inputs, output, size_dict, optimize="auto"):
    """A ContractionTree for the contraction, dispatching on the type of
    ``optimize``. A tree is returned unchanged."""
    if isinstance(optimize, ContractionTree):
        return optimize

    if isinstance(optimize, str):
        if optimize in _PRESETS_TREE:
            return _PRESETS_TREE[optimize](inputs, output, size_dict)
        result = preset_to_optimizer(optimize)(inputs, output, size_dict)
    elif _is_path(optimize):
        result = optimize
    elif hasattr(optimize, "search"):
        return optimize.search(inputs, output, size_dict)
    else:
        result = optimize(inputs, output, size_dict)
    if isinstance(result, ContractionTree):
        return result
    return ContractionTree.from_path(inputs, output, size_dict, path=result)


def find_path(inputs, output, size_dict, optimize="auto"):
    """A linear contraction path."""
    if _is_path(optimize):
        return tuple(map(tuple, optimize))
    if isinstance(optimize, ContractionTree):
        return optimize.get_path()
    if isinstance(optimize, str):
        if optimize in _PRESETS_TREE and optimize not in _PRESETS:
            return _PRESETS_TREE[optimize](
                inputs, output, size_dict
            ).get_path()
        result = preset_to_optimizer(optimize)(inputs, output, size_dict)
    elif callable(optimize):
        result = optimize(inputs, output, size_dict)
    else:
        raise TypeError(f"Can't interpret optimize={optimize!r}")
    if isinstance(result, ContractionTree):
        return result.get_path()
    return tuple(map(tuple, result))


# -- caches ---------------------------------------------------------------

_PATH_CACHE = {}
_TREE_CACHE = {}
_EXPR_CACHE = {}
_CACHE_LOCK = threading.Lock()


def clear_caches():
    with _CACHE_LOCK:
        _PATH_CACHE.clear()
        _TREE_CACHE.clear()
        _EXPR_CACHE.clear()


def _cacheable_optimize(optimize):
    return isinstance(optimize, str)


# -- array_contract family ------------------------------------------------


def array_contract_path(
    inputs, output=None, size_dict=None, shapes=None, optimize="auto",
    cache=True,
):
    """A contraction path for arbitrary hashable index labels."""
    c_inputs, c_output, c_size_dict, _ = canonicalize_inputs(
        inputs, output, shapes=shapes, size_dict=size_dict
    )
    if cache and _cacheable_optimize(optimize):
        key = hash_contraction(
            c_inputs, c_output, c_size_dict, optimize=optimize
        )
        with _CACHE_LOCK:
            hit = _PATH_CACHE.get(key)
        if hit is not None:
            return hit
        path = find_path(c_inputs, c_output, c_size_dict, optimize)
        with _CACHE_LOCK:
            _PATH_CACHE[key] = path
        return path
    return find_path(c_inputs, c_output, c_size_dict, optimize)


def array_contract_tree(
    inputs, output=None, size_dict=None, shapes=None, optimize="auto",
    canonicalize=True,
):
    """A ContractionTree for arbitrary hashable index labels."""
    if canonicalize:
        c_inputs, c_output, c_size_dict, _ = canonicalize_inputs(
            inputs, output, shapes=shapes, size_dict=size_dict
        )
    else:
        c_inputs, c_output = tuple(map(tuple, inputs)), tuple(output)
        c_size_dict = size_dict
    return find_tree(c_inputs, c_output, c_size_dict, optimize)


class Via:
    """Wrap an expression with input and output transfers: each input
    goes through ``constructor`` (default: ``torch.as_tensor`` as
    ``dtype`` on ``device``), the output through ``extractor`` (for
    example ``lambda t: t.cpu().numpy()``)."""

    def __init__(
        self, fn, constructor=None, extractor=None, device=None,
        dtype=None,
    ):
        self.fn = fn
        self.device = device
        self.dtype = dtype
        self.constructor = constructor
        self.extractor = extractor

    def _put(self, x):
        if self.constructor is not None:
            return self.constructor(x)
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def __call__(self, *arrays, **kwargs):
        out = self.fn(*map(self._put, arrays), **kwargs)
        if self.extractor is not None:
            out = self.extractor(out)
        return out


def _is_double(a):
    dtype = getattr(a, "dtype", None)
    if dtype is None:
        dtype = np.asarray(a).dtype
    return str(dtype).removeprefix("torch.") in ("float64", "complex128")


def _plane_dtype_of(arrays):
    """float64 if any input is float64 or complex128, else float32."""
    return torch.float64 if any(map(_is_double, arrays)) else torch.float32


class Expression:
    """A reusable contraction expression: ``expr(*arrays, **opts)`` runs
    ``tree.contract`` with the expression's options (``device``,
    ``plane_dtype``, ``strip_exponent``, ``implementation``,
    ``slice_batch``, ``autojit``) updated by ``opts``. The tree keeps the contractor
    it plans, so every call after the first reuses it. Stripped results
    come back as ``(mantissa, exponent)`` pairs.

    ``constants`` (a dict position -> array) are closed over, and the
    expression then takes only the other (variable) arrays, in order.
    Per device, plane dtype and options, the constants go to the device
    once and the steps that only they reach, and no sliced index, run
    once, at the first call; later calls run only the other steps
    (``ops.executor.make_full_contractor(constants=...)``), as the
    reference's jit folds them. ``autojit=True`` captures each call as
    one CUDA graph on the card, the folded steps' results read by it, as
    the reference jits its folded expression.
    """

    __slots__ = ("tree", "_kwargs", "_constants", "_folded", "__weakref__")

    def __init__(self, tree, constants=None, **kwargs):
        self.tree = tree
        self._kwargs = kwargs
        if constants:
            self._constants = {
                int(pos): a for pos, a in sorted(constants.items())
            }
        else:
            self._constants = None
        self._folded = {}

    def _folded_contractor(self, device=None, plane_dtype=None,
                           strip_exponent=False, implementation=None,
                           slice_batch=None, autojit=False):
        """The contractor closing over the constants, made once per
        device, plane dtype and options; returns it and its device."""
        dev = resolve_device(device)
        implementation, slice_batch = _defaults(implementation, slice_batch)
        key = (dev, plane_dtype, strip_exponent, implementation, slice_batch,
               autojit)
        fn = self._folded.get(key)
        if fn is None:
            tensors = to_tensors(
                list(self._constants.values()), dev, plane_dtype
            )
            fn = self._folded[key] = make_full_contractor(
                self.tree, dev, strip_exponent=strip_exponent,
                slice_batch=slice_batch, implementation=implementation,
                plane_dtype=plane_dtype,
                constants=dict(zip(self._constants, tensors)),
                autojit=autojit,
            )
        return fn, dev

    def __call__(self, *arrays, **kwargs):
        opts = {**self._kwargs, **kwargs}
        opts.pop("backend", None)  # torch is the only backend
        consts = self._constants or {}
        n_var = self.tree.N - len(consts)
        if len(arrays) != n_var:
            if consts:
                raise ValueError(
                    f"Expression with {len(consts)} constants takes "
                    f"{n_var} variable arrays, got {len(arrays)}."
                )
            raise ValueError(
                f"Expression takes {self.tree.N} arrays, got {len(arrays)}."
            )
        if opts.get("plane_dtype") is None:
            opts["plane_dtype"] = _plane_dtype_of(
                [*arrays, *consts.values()]
            )
        if not consts:
            return self.tree.contract(arrays, **opts)
        fn, dev = self._folded_contractor(**opts)
        return fn(*to_tensors(arrays, dev, opts["plane_dtype"]))

    def __repr__(self):
        return f"<Expression(N={self.tree.N})>"


def array_contract_expression(
    inputs,
    output=None,
    size_dict=None,
    shapes=None,
    optimize="auto",
    cache=True,
    constants=None,
    **kwargs,
):
    """A reusable expression ``expr(*arrays)``.

    ``constants`` may be a dict ``{position: array}``: those tensors are
    closed over and ``expr`` then takes only the remaining (variable)
    arrays, in order. ``kwargs`` are the contraction's options
    (``device``, ``plane_dtype``, ``strip_exponent``,
    ``implementation``, ``slice_batch``).
    """
    if constants is not None and not isinstance(constants, dict):
        raise TypeError("constants must be a dict {position: array}")
    if constants:
        shapes = list(shapes) if shapes is not None else None
        if shapes is not None:
            for pos, arr in constants.items():
                shapes[pos] = getattr(arr, "shape", ())
        kwargs["constants"] = constants
        cache = False  # constants are concrete arrays - don't cache
    c_inputs, c_output, c_size_dict, _ = canonicalize_inputs(
        inputs, output, shapes=shapes, size_dict=size_dict
    )
    if cache and _cacheable_optimize(optimize):
        key = hash_contraction(
            c_inputs,
            c_output,
            c_size_dict,
            optimize=optimize,
            **{k: repr(v) for k, v in kwargs.items()},
        )
        with _CACHE_LOCK:
            hit = _EXPR_CACHE.get(key)
        if hit is not None:
            return hit
        expr = _build_expression(
            c_inputs, c_output, c_size_dict, optimize, **kwargs
        )
        with _CACHE_LOCK:
            _EXPR_CACHE[key] = expr
        return expr
    return _build_expression(
        c_inputs, c_output, c_size_dict, optimize, **kwargs
    )


def _build_expression(inputs, output, size_dict, optimize, **kwargs):
    tree = find_tree(inputs, output, size_dict, optimize)
    return Expression(tree, **kwargs)


def array_contract(
    arrays,
    inputs,
    output=None,
    optimize="auto",
    cache_expression=True,
    **kwargs,
):
    """Contract ``arrays`` described by (hashable) ``inputs`` /
    ``output`` index labels."""
    shapes = tuple(getattr(a, "shape", ()) for a in arrays)
    expr = array_contract_expression(
        inputs,
        output,
        shapes=shapes,
        optimize=optimize,
        cache=cache_expression,
        **kwargs,
    )
    return expr(*arrays)


# -- einsum family --------------------------------------------------------


def einsum_tree(*args, optimize="auto", shapes=False, **kwargs):
    """The ContractionTree for an einsum equation (string or interleaved
    format)."""
    eq, arrays = parse_einsum_input(args, shapes=shapes)
    inputs, output = eq_to_inputs_output(eq)
    if shapes:
        shps = arrays
    else:
        shps = tuple(getattr(a, "shape", ()) for a in arrays)
    return array_contract_tree(
        inputs, output, shapes=shps, optimize=optimize, **kwargs
    )


def einsum_expression(
    *args, optimize="auto", shapes=True, constants=None, **kwargs
):
    """A reusable einsum expression from an equation and shapes.

    ``constants`` may be a sequence of positions whose entries among the
    shape arguments are actual arrays, or a dict ``{position: array}``.
    """
    if constants is not None and not isinstance(constants, dict):
        # positions convention: the "shape" at each position is an array
        eq_or_arrays = list(args)
        const_dict = {}
        for pos in constants:
            const_dict[int(pos)] = eq_or_arrays[1 + int(pos)]
            eq_or_arrays[1 + int(pos)] = getattr(
                eq_or_arrays[1 + int(pos)], "shape", ()
            )
        args = tuple(eq_or_arrays)
        constants = const_dict
    eq, shps = parse_einsum_input(args, shapes=shapes)
    inputs, output = eq_to_inputs_output(eq)
    return array_contract_expression(
        inputs,
        output,
        shapes=shps,
        optimize=optimize,
        constants=constants,
        **kwargs,
    )


def einsum(*args, optimize="auto", **kwargs):
    """Drop-in ``einsum`` planned by ``optimize`` and run by the port's
    executor. Takes string equations (with ellipses) and the
    interleaved-argument format."""
    eq, arrays = parse_einsum_input(args)
    inputs, output = eq_to_inputs_output(eq)
    return array_contract(
        arrays, inputs, output, optimize=optimize, **kwargs
    )


def ncon(arrays, indices, optimize="auto", **kwargs):
    """ncon-style contraction: positive integer labels are contracted,
    negative labels are outputs ordered ``-1, -2, ...``."""
    inputs = tuple(tuple(term) for term in indices)
    neg = sorted(
        {ix for term in inputs for ix in term if isinstance(ix, int) and ix < 0},
        reverse=True,
    )
    output = tuple(neg)
    return array_contract(
        arrays, inputs, output, optimize=optimize, **kwargs
    )
