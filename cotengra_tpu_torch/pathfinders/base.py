"""Base class for path optimizers (counterpart of
``cotengra_tpu/pathfinders/base.py``)."""


class PathOptimizer:
    """Base for all path optimizers: callable on ``(inputs, output,
    size_dict)`` returning a *linear* path, with ``ssa_path`` and
    ``search`` (returning a ContractionTree) variants.

    Also takes ``opt_einsum``'s call, ``(input_sets, output_set,
    idx_dict, memory_limit)``.
    """

    minimize = "flops"

    def ssa_path(self, inputs, output, size_dict):
        raise NotImplementedError

    def _detect_opt_einsum_call(self, args):
        if len(args) == 4:
            inputs, output, size_dict, _memory_limit = args
        else:
            inputs, output, size_dict = args
        return tuple(map(tuple, inputs)), tuple(output), size_dict

    def __call__(self, *args, **kwargs):
        from ..tree import ssa_to_linear

        inputs, output, size_dict = self._detect_opt_einsum_call(args)
        return ssa_to_linear(
            self.ssa_path(inputs, output, size_dict), len(inputs)
        )

    def search(self, inputs, output, size_dict):
        """Run and return a :class:`~cotengra_tpu_torch.tree.ContractionTree`."""
        from ..tree import ContractionTree

        return ContractionTree.from_path(
            inputs, output, size_dict,
            ssa_path=self.ssa_path(inputs, output, size_dict),
        )
