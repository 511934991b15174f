"""numpy inputs -> the port's tensors.

Networks arrive as numpy arrays (complex ones from ``rand_circuit_tn``
after ``absorb_simple_tensors``, real ones for networks such as
``lattice_equation``), as the JAX package takes them; they become the
port's tensors (or split-complex plane tensors) here.
"""

import numpy as np
import torch

from . import tracing
from ._device import resolve_device, resolve_plane_dtype


def to_plane_array(a):
    """Host-side: complex array -> real ``(2, *shape)`` re/im plane stack.
    Real arrays get a zero imaginary plane."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        return np.ascontiguousarray(np.stack([a.real, a.imag]))
    return np.stack([a, np.zeros_like(a)])


def to_plane_tensors(arrays, device="cuda", plane_dtype=torch.float32):
    """numpy arrays -> ``(2, *shape)`` plane tensors of ``plane_dtype``
    on ``device``."""
    if tracing.ON:
        tracing.begin()
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    planes = [to_plane_array(a) for a in arrays]
    out = [torch.from_numpy(p).to(device=dev, dtype=pdt) for p in planes]
    if tracing.ON:
        tracing.end("inputs.upload", len(out), tracing.host_bytes(planes))
    return out


def to_tensors(arrays, device="cuda", dtype=torch.float32):
    """numpy arrays (or tensors) -> tensors on ``device``: real arrays
    as ``dtype`` (float32 or float64), complex arrays as the complex
    type of the same precision."""
    if tracing.ON:
        tracing.begin()
    dev = resolve_device(device)
    rdt = resolve_plane_dtype(dtype)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    out = []
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.require(a, requirements="C"))
        out.append(a.to(device=dev, dtype=cdt if a.is_complex() else rdt))
    if tracing.ON:
        tracing.end("inputs.upload", len(out), tracing.host_bytes(arrays))
    return out
