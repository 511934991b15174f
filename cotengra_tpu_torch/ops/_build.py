"""Build and load the port's native libraries.

The CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for Hopper
(``sm_90a``), and the host planning library (``ops/native/kernels.cpp``)
with the host C++ compiler (``g++``), each into a shared library with a
plain C interface at first use, loaded with ctypes. The libraries land
in ``build/cotengra_tpu_torch/`` at the root of the checkout that holds
the package, named by a hash of the sources and flags (and, for the host
library, the machine), so an edited source rebuilds and an unchanged one
loads at once. An installed copy of the package (no checkout around it)
has no build location and raises at first use.
"""

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / "csrc"
_ROOT = _PKG_DIR.parent
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
HOST_CXX = "g++"
HOST_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


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


def _driver_link_flags(nvcc):
    """Link the CUDA driver library (``cuTensorMapEncodeTiled``) against
    the toolkit's stub; the driver's own copy loads at run time."""
    home = Path(nvcc).resolve().parent.parent
    stubs = (home / "lib64" / "stubs",
             home / "targets" / "x86_64-linux" / "lib" / "stubs")
    return [f"-L{d}" for d in stubs if d.is_dir()] + ["-lcuda"]


def _start(cmd):
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )


def _finish(proc, cmd):
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}"
        )


def build_library():
    """Compile ``csrc/*.cu`` unless the library for these sources
    exists: one nvcc per source, all started together, then one link.
    Returns its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under a private name, then rename: concurrent builds never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        jobs, objs = [], []
        try:
            for src in _sources():
                objs.append(f"{tmp}/{src.stem}.o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
                jobs.append((_start(cmd), cmd))
            for proc, cmd in jobs:
                _finish(proc, cmd)
        finally:
            for proc, _ in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = f"{tmp}/lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs,
               *_driver_link_flags(nvcc)]
        _finish(_start(cmd), cmd)
        os.replace(lib, path)
    return path


def host_library_path(src):
    """Where the host library built from the C++ source ``src`` lives."""
    h = hashlib.sha256()
    h.update(" ".join((HOST_CXX, *HOST_CXX_FLAGS)).encode())
    h.update(platform.machine().encode())
    h.update(Path(src).read_bytes())
    return build_dir() / f"lib{Path(src).stem}_host_{h.hexdigest()[:16]}.so"


def _compile_host(src, out):
    """``g++ -O3 -march=native ...``, then, where that fails, the same
    without ``-march=native``. Raises with the compiler's messages."""
    errors = []
    for drop in ((), ("-march=native",)):
        flags = [f for f in HOST_CXX_FLAGS if f not in drop]
        cmd = [HOST_CXX, *flags, str(src), "-o", str(out)]
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=600
            )
        except (OSError, subprocess.TimeoutExpired) as exc:
            errors.append(f"{' '.join(cmd)}: {exc}")
            continue
        if proc.returncode == 0:
            return
        errors.append(
            f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr}"
        )
    raise RuntimeError(
        "the host C++ compiler could not build "
        f"{Path(src).name}:\n" + "\n".join(errors)
    )


def build_host_library(src):
    """Compile the C++ source ``src`` into a host shared library unless
    the library for this source, these flags and this machine exists, and
    return its path. Concurrent processes take turns on a file lock, so
    one compiles and the others load its result; the library is written
    under a private name and renamed, so no process loads a half-written
    file."""
    path = host_library_path(src)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_name(path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
            out = Path(tmp) / path.name
            _compile_host(src, out)
            os.replace(out, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load, and declare the C functions' signatures."""
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.ctg_gate_chain_f32
    fn.argtypes = [
        ctypes.c_void_p,                    # x (device)
        ctypes.c_void_p,                    # out (device)
        ctypes.c_void_p,                    # index tables (device)
        ctypes.POINTER(ctypes.c_int64),     # meta (host)
        ctypes.c_int,                       # meta length
        ctypes.c_void_p,                    # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    fn = lib.ctg_bmm_absmax_f32
    fn.argtypes = [
        ctypes.c_void_p,                    # x (device)
        ctypes.c_void_p,                    # y^T (device)
        ctypes.c_void_p,                    # out (device)
        ctypes.c_void_p,                    # absmax (device)
        ctypes.c_void_p,                    # workspace (split y, split K)
        ctypes.c_int64,                     # B
        ctypes.c_int64,                     # M
        ctypes.c_int64,                     # K
        ctypes.c_int64,                     # N
        ctypes.c_int,                       # splits
        ctypes.c_int64,                     # k_chunk
        ctypes.c_void_p,                    # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    fn = lib.ctg_svd_core_workspace
    fn.argtypes = [ctypes.c_int64] * 4      # m, n, k, element bytes
    fn.restype = ctypes.c_int64
    fn = lib.ctg_svd_core
    fn.argtypes = [
        ctypes.c_int,                       # dtype: 0 float32, 1 float64
        ctypes.c_void_p,                    # M (device)
        ctypes.c_int64,                     # m
        ctypes.c_int64,                     # n
        ctypes.c_int64,                     # k
        ctypes.c_void_p,                    # U (device)
        ctypes.c_void_p,                    # s (device)
        ctypes.c_void_p,                    # V (device)
        ctypes.c_void_p,                    # workspace (device)
        ctypes.c_void_p,                    # control words (device, zeroed)
        ctypes.c_void_p,                    # unconverged launches (device)
        ctypes.c_void_p,                    # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    fn = lib.ctg_qr_core_blocks
    fn.argtypes = []
    fn.restype = ctypes.c_int
    fn = lib.ctg_qr_core
    fn.argtypes = [
        ctypes.c_int,                       # phase: 0 factor, 1 apply
        ctypes.c_int,                       # dtype: 0 float32, 1 float64
        ctypes.POINTER(ctypes.c_int64),     # per side (m, n, k, blocks)
        ctypes.POINTER(ctypes.c_void_p),    # per side 11 device pointers
        ctypes.c_int64,                     # chi (apply)
        ctypes.c_void_p,                    # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return lib
