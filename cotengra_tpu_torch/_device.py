"""Device and plane-dtype resolution for the PyTorch port.

Every public entry point takes an explicit ``device=``: there is no
silent device choice, and asking for ``"cuda"`` on a machine without a
card raises instead of running on the CPU.
"""

import torch

PLANE_DTYPES = (torch.float32, torch.float64)


def full_fp32_matmuls():
    """Run float32 matmuls in true float32 (TF32 off).

    The reference runs its dots at ``precision="highest"``; reduced
    precision multiplies cost percent-level amplitude error on the
    Sycamore contraction.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device):
    """``torch.device`` for ``device`` (a name or a device).

    Raises for ``"cuda"`` when no card is visible, and for device types
    the port does not run on.
    """
    if device is None:
        raise ValueError("an explicit device= is required")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device "
                "is available"
            )
        full_fp32_matmuls()
        if dev.index is None:
            # tensors report their index; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def resolve_plane_dtype(plane_dtype):
    """Validate a plane dtype: float32 (the main path) or float64."""
    if plane_dtype not in PLANE_DTYPES:
        raise ValueError(
            f"plane_dtype must be torch.float32 or torch.float64, got "
            f"{plane_dtype}"
        )
    return plane_dtype

