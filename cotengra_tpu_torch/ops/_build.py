"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface at first use, and loaded with
ctypes. The library lands in ``build/cotengra_tpu_torch/`` at the root
of the checkout that holds the package, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at
once. An installed copy of the package (no checkout around it) has no
build location and raises at first use.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / "csrc"
_ROOT = _PKG_DIR.parent
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def build_dir():
    """``build/cotengra_tpu_torch/`` of the checkout holding the package."""
    if not (_ROOT / "pyproject.toml").is_file():
        raise RuntimeError(
            f"cotengra_tpu_torch at {_PKG_DIR} is not inside a checkout of "
            "its repository; the CUDA kernels build only into a checkout's "
            "build/ directory"
        )
    return _ROOT / "build" / "cotengra_tpu_torch"


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return nvcc


def library_path():
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libctg_kernels_{h.hexdigest()[:16]}.so"


def build_library():
    """Compile ``csrc/*.cu`` unless the library for these sources
    exists. Returns its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load, and declare the C functions' signatures."""
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ctg_gate_apply_f32
    fn.argtypes = [
        ctypes.c_void_p,                    # x (device)
        ctypes.c_void_p,                    # out (device)
        ctypes.c_void_p,                    # y (device)
        ctypes.POINTER(ctypes.c_int64),     # meta (host)
        ctypes.c_int,                       # meta length
        ctypes.c_void_p,                    # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return lib
