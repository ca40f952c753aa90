"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds, not minutes.  Libraries go into
``build/`` at the repository root, named by a digest of their sources and
flags, so an edited source is never served by a stale library.

Nothing is built when a module is imported: the first launch of a kernel
builds its library (:func:`library`), under one lock, because the host
backend's worker threads reach the same kernel at the same moment on the
first round; once loaded, a library is read without the lock.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Each wrapper counts its launches on a :class:`LaunchCounter`, incremented
exactly where the kernel is launched; :func:`launch_counts` and
:func:`reset_launches` read and zero them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("fused_scatter", "topk_compress", "kmeans_assign", "flash_attention",
           "ssd_scan", "accumulate", "scatter_add", "pagerank_credits", "logreg_margin",
           "nmf_init", "nmf_products")
HEADERS = ("common.cuh", "bitonic.cuh", "dtype.cuh", "radix_select.cuh", "mma_tf32.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes argument types of the C entry points (a pointer or a stream must
# not go through as a 32-bit int)
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float

# the element types the kernels take, as their C entry points' dtype code
# (csrc/dtype.cuh: kF32, kBF16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SHARED_BYTES = 232448  # a CTA's shared memory on Hopper (227 KB)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------


class LaunchCounter:
    """A plain count of one kernel's launches (thread-safe increment; a
    wrapper that launches its kernel once per row adds the rows)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()
        _COUNTERS[name] = self

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counts() -> Dict[str, int]:
    """``{kernel name: launches}`` for every kernel wrapper imported so far."""
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launches() -> None:
    for c in _COUNTERS.values():
        c.reset()


# ---------------------------------------------------------------------------
# Kernels without a backward
# ---------------------------------------------------------------------------


class _ForwardOnly(torch.autograd.Function):
    """``fn(*inputs)`` as one node of the graph whose backward raises: the
    output keeps a ``grad_fn``, so a gradient through it fails loudly
    instead of silently leaving the inputs out of the graph."""

    @staticmethod
    def forward(ctx, message, fn, *inputs):
        ctx.message = message
        return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(ctx.message)


def differentiated(*inputs: torch.Tensor) -> bool:
    """Whether a call on ``inputs`` is being recorded for a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def forward_only(message: str, fn, *inputs: torch.Tensor):
    """``fn(*inputs)`` whose gradient raises ``NotImplementedError(message)``
    — on every device, the plain version a CPU tensor runs included.  The
    JAX package's Pallas kernels define no backward, so the port's define
    none either.  Call it only where :func:`differentiated` holds: a call
    with no gradient to record goes straight to ``fn``."""
    return _ForwardOnly.apply(message, fn, *inputs)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / part).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) per source
    built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to its ``argtypes``; every function
    returns the ``cudaError_t`` of its launch as an int."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn}: CUDA error {code}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(fn: str, *tensors: torch.Tensor) -> int:
    """The C dtype code of ``tensors``, which must all be float32 or all
    bfloat16; raises ``TypeError`` naming the kernel ``fn`` otherwise."""
    dtype = tensors[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"the {fn} kernel takes float32 or bfloat16 inputs of one dtype, "
                        f"got {[str(t.dtype) for t in tensors]}")
    return DTYPES[dtype]


def scratch(nbytes: int, nblocks: int, device: torch.device, reserved: int = 0):
    """None while one CTA's working set of ``nbytes`` (beside ``reserved``
    bytes of static shared memory) fits in shared memory; else a device
    buffer of ``nblocks`` such sets, which the kernel works in instead."""
    if nbytes + reserved <= MAX_SHARED_BYTES:
        return None
    return torch.empty(nblocks * nbytes, dtype=torch.uint8, device=device)
