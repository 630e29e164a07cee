"""Build and bind the port's hand-written CUDA kernels.

The sources in ``hedgehog_tpu_torch/csrc`` are compiled by ``nvcc`` into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``: one ``nvcc -c`` per ``.cu`` file,
all started together, then one link.  The build happens at first use,
into ``build/hedgehog_tpu_torch/<hash>/`` beside the package, keyed by a
hash of the sources and flags; nothing is built when the package is
imported.  Each kernel's entry point returns ``cudaGetLastError()`` after
its launch, and :class:`CudaKernel` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

__all__ = ["CudaKernel", "build_library", "load_library", "resident_grid", "BUILD_ROOT",
           "NVCC_FLAGS", "host_to_device"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "hedgehog_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libhh_kernels.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for path in cus + cuhs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[pathlib.Path, float]:
    """Compile the kernels unless a library for these sources exists.
    Returns (library path, seconds spent building; 0.0 when cached).  The
    compiler's output, register counts included, is kept in ``build.log``
    beside the library."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    cus, _ = _sources()
    objs = [out_dir / f"{cu.stem}.{pid}.o" for cu in cus]
    tmp = out_dir / f"{_LIB_NAME}.{pid}.tmp"
    t0 = time.perf_counter()
    compiles = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)] for cu, obj in zip(cus, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in compiles]
    steps = [(cmd, *proc.communicate(), proc.returncode) for cmd, proc in zip(compiles, procs)]
    if all(rc == 0 for *_, rc in steps):
        link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, proc.stdout, proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        "".join(" ".join(cmd) + "\n" + out + err for cmd, out, err, _ in steps))
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, _, err, rc in steps:
        if rc != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({rc}):\n{err[-6000:]}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build_library()[0]))
    lib.hh_error_string.argtypes = [ctypes.c_int]
    lib.hh_error_string.restype = ctypes.c_char_p
    lib.hh_exact_price_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.hh_exact_price_grid.restype = ctypes.c_int
    lib.hh_qe_price_grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.hh_qe_price_grid.restype = ctypes.c_int
    lib.hh_qem_price_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.hh_qem_price_grid.restype = ctypes.c_int
    lib.hh_surface_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.hh_surface_grid.restype = ctypes.c_int
    lib.hh_exact_surface_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.hh_exact_surface_grid.restype = ctypes.c_int
    lib.hh_surface_occupancy.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.hh_surface_occupancy.restype = ctypes.c_int
    lib.hh_rb_greeks_occupancy.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    lib.hh_rb_greeks_occupancy.restype = ctypes.c_int
    return lib


def resident_grid(symbol: str, device: torch.device, *args) -> int:
    """The grid of an accumulating price kernel on ``device``: one resident
    wave of it, from the library's ``symbol(*args, int* grid)``.  The
    runtime's answer depends only on the kernel, the card and ``args``, so
    it is asked once per (symbol, card, args)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return _resident_grid(symbol, index, *args)


@functools.lru_cache(maxsize=None)
def _resident_grid(symbol: str, index: int, *args) -> int:
    grid = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(load_library(), symbol)(*args, ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return grid.value


def launch_occupancy(symbol: str, device: torch.device, *args) -> dict:
    """A kernel's occupancy from the library's ``symbol(*args, int out[7])``
    (threads a block, resident blocks per SM, SMs, dynamic and static shared
    bytes, registers and local (spill) bytes a thread, from the CUDA
    runtime) as a dict."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = getattr(load_library(), symbol)(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    threads, per_sm, _sms, dynamic, static, registers, local = out
    return dict(threads=threads, blocks_per_sm=per_sm, warps_per_sm=per_sm * threads // 32,
                smem_bytes=dynamic + static, registers=registers, local_bytes=local)


class CudaKernel:
    """One kernel's C entry point, with the count of its launches.

    ``launches`` grows by one for each launch that the CUDA runtime
    accepted, and nowhere else; a run reads it to show that its path went
    through the kernel."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        fn = getattr(load_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            msg = load_library().hh_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """``array`` (numpy) on ``device`` in one copy: on a GPU from a pinned
    buffer and asynchronous (no wait for the work already queued on the
    stream, as a copy from pageable memory makes), on the CPU a view.  The
    buffer is taken pinned (``Tensor.pin_memory`` would first ask CUDA
    whether the array's pageable memory is pinned)."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return staged.copy_(t).to(device, non_blocking=True)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` has the dtype, shape and layout a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_grid(grid) -> None:
    """Raise unless ``grid`` (a launch's blocks, where a wrapper takes one)
    is a positive int or None."""
    if grid is not None and (isinstance(grid, bool) or not isinstance(grid, int) or grid < 1):
        raise ValueError(f"grid must be a positive int or None; got {grid!r}")


def require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernels take cuda tensors; got {t.device}")
