"""Carry the reference's state across to the port.

The reference package consumes numpy complex arrays (``rand_circuit_tn``
output after ``absorb_simple_tensors``) and trees loaded with
``cotengra_tpu.utils.io.load_tree``. Trees and plan files load with
that function unchanged; arrays become the port's plane tensors here.
"""

import numpy as np
import torch

from ._device import resolve_device, resolve_plane_dtype


def to_plane_array(a):
    """Host-side: complex array -> real ``(2, *shape)`` re/im plane stack.
    Real arrays get a zero imaginary plane."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return np.ascontiguousarray(np.stack([a.real, a.imag]))
    return np.stack([a, np.zeros_like(a)])


def to_plane_tensors(arrays, device, plane_dtype):
    """numpy arrays -> ``(2, *shape)`` plane tensors of ``plane_dtype``
    on ``device``."""
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    return [
        torch.from_numpy(to_plane_array(a)).to(device=dev, dtype=pdt)
        for a in arrays
    ]
