"""opt_einsum interoperability (counterpart of ``cotengra_tpu/oe.py``).
Optional: opt_einsum is used only where it is installed
(``HAS_OPT_EINSUM``); without it both names raise or do nothing.

- ``OEPathOptimizer`` subclasses ``opt_einsum.paths.PathOptimizer``, so
  that any of the port's path optimizers, wrapped in it, can be passed
  as ``opt_einsum.contract(..., optimize=opt)``.
- ``register_opt_einsum_presets()`` registers the main preset names into
  opt_einsum's registry so ``optimize="cotengra-auto"`` etc. work there.
"""

try:
    import opt_einsum as oe

    HAS_OPT_EINSUM = True
except ImportError:
    oe = None
    HAS_OPT_EINSUM = False


if HAS_OPT_EINSUM:

    class OEPathOptimizer(oe.paths.PathOptimizer):
        """Adapter: wrap any of the port's path optimizers for
        opt_einsum."""

        def __init__(self, optimizer):
            self.optimizer = optimizer

        def __call__(self, inputs, output, size_dict, memory_limit=None):
            path = self.optimizer(
                tuple(map(tuple, inputs)), tuple(output), dict(size_dict)
            )
            return [tuple(p) for p in path]

    def register_opt_einsum_presets(prefix="cotengra-"):
        """Register our presets as ``{prefix}{name}`` path functions in
        opt_einsum.
        """
        from .interface import _PRESETS

        registered = []
        for name, fn in list(_PRESETS.items()):

            def make(fn):
                def path_fn(
                    input_sets, output_set, idx_dict, memory_limit=None
                ):
                    inputs = tuple(map(tuple, input_sets))
                    path = fn(inputs, tuple(output_set), dict(idx_dict))
                    return [tuple(p) for p in path]

                return path_fn

            key = f"{prefix}{name}"
            try:
                oe.paths.register_path_fn(key, make(fn))
                registered.append(key)
            except KeyError:
                pass  # already registered
        return registered

else:

    class OEPathOptimizer:  # pragma: no cover
        def __init__(self, optimizer):
            raise ImportError("opt_einsum is not installed.")

    def register_opt_einsum_presets(prefix="cotengra-"):  # pragma: no cover
        return []
