"""Slicing and the sliced contraction of a whole tree.

``contract_tree`` sums the contraction over every slice of a sliced
tree, in flat slice-id order (``tree.slice_key``): the order of the
reference amplitude sidecars under ``plans/``. Slices run one after the
other in a host loop.
"""

import numpy as np
import torch

from .._device import resolve_device, resolve_plane_dtype
from ..convert import to_plane_tensors
from .grouped import make_grouped_contractor


def _sliced_axes_per_input(tree):
    """For each input: the (axis, ind) pairs of sliced indices, in
    descending axis order (so successive removals keep positions
    valid)."""
    out = []
    for term in tree.inputs:
        axes = [
            (ax, ix)
            for ax, ix in enumerate(term)
            if ix in tree.sliced_inds
        ]
        axes.sort(reverse=True)
        out.append(tuple(axes))
    return tuple(out)


def slice_arrays(tree, arrays, i, axis_offset=0):
    """The input arrays of slice number ``i``.

    ``arrays`` are numpy arrays (host) or torch tensors (selected as
    views on their device); ``axis_offset=1`` addresses plane stacks,
    whose leading axis is the plane.
    """
    key = tree.slice_key(i)
    out = []
    for arr, axes in zip(arrays, _sliced_axes_per_input(tree)):
        for ax, ix in axes:
            if isinstance(arr, torch.Tensor):
                arr = arr.select(ax + axis_offset, key[ix])
            else:
                arr = np.take(arr, key[ix], axis=ax + axis_offset)
        out.append(arr)
    return out


def contract_slices(tree, core, planes):
    """Sum ``core`` over all slices of ``tree``.

    ``planes`` are the raw (unsliced) inputs as ``(2, *shape)`` plane
    tensors; returns the ``(2, *out_shape)`` planes of the sum.
    """
    acc = None
    for i in range(tree.multiplicity):
        res = core(*slice_arrays(tree, planes, i, axis_offset=1))
        acc = res if acc is None else acc + res
    return acc


def contract_tree(tree, arrays, device, plane_dtype=torch.float32):
    """Contract ``tree`` over all its slices on ``device``.

    ``arrays`` are the raw complex numpy inputs (the arrays the
    reference package consumes); the contraction runs on split-complex planes of
    ``plane_dtype``. Returns the complex result on ``device``.
    """
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    core = make_grouped_contractor(tree, dev, pdt)
    planes = to_plane_tensors(arrays, dev, pdt)
    out = contract_slices(tree, core, planes)
    return torch.complex(out[0], out[1])
