"""Build and load the port's CUDA kernels (``dpvo_tpu_torch/csrc``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library, loaded with ``ctypes``.  The
build happens at first use, one ``nvcc`` per source started together, into
``dpvo_tpu_torch/_build/`` (listed in ``.gitignore``); the library name
carries a hash of the sources, headers and flags, so an edited file
rebuilds.

``launches`` counts kernel launches by name: each wrapper adds one where it
launches its kernel (``count``), so a run can show which kernels its path
went through.  A CUDA graph capture launches nothing: inside
``captured_launches`` the wrappers called on that thread count into the
capture's own counter instead, and each replay of the graph adds it
(``replayed``); other threads go on counting into ``launches``, so a
capture in a worker thread leaves the engine thread's counts exact.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ba_blocks.cu", "corr_enc.cu", "corr_raw.cu", "segment_sums.cu",
           "stamp.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()
build_seconds: float | None = None   # wall time of this process's build

_lib = None
_lock = threading.Lock()

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "dpvo_corr_enc_f32": [_VP] * 7 + [_VP] + [_I] * 6 + [_VP],
    "dpvo_corr_enc_bf16": [_VP] * 7 + [_VP] + [_I] * 6 + [_VP],
    "dpvo_corr_raw": [_I] * 4 + [_VP] * 6 + [_I] * 6 + [_VP],
    "dpvo_corr_probe": [_I] + [_VP] * 6 + [_F] + [_I] * 5 + [_VP],
    "dpvo_segment_softmax_sums": [_VP] * 5 + [_I] * 3 + [_VP],
    "dpvo_segment_sums": [_VP] * 3 + [_I] * 3 + [_VP],
    "dpvo_stamp_set": [_VP, _VP, _L] + [_I] * 3 + [_VP],
    "dpvo_stamp_graph": [_VP] * 2 + [_I] * 3 + [_VP],
    "dpvo_ba_blocks": [_VP] * 10 + [_I] * 2 + [_VP],
}


_capturing = threading.local()   # .counter: this thread's capture's counts


def reset_launches():
    launches.clear()


def count(name: str):
    """Count one launch of kernel ``name``: into the capture this thread is
    recording (``captured_launches``), else into ``launches``."""
    captured = getattr(_capturing, "counter", None)
    (launches if captured is None else captured)[name] += 1


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a Counter of the launches that
    wrappers called on this thread count inside the block, which stay out
    of ``launches`` (the capture records the kernels, it runs none)."""
    captured: collections.Counter = collections.Counter()
    outer = getattr(_capturing, "counter", None)
    _capturing.counter = captured
    try:
        yield captured
    finally:
        _capturing.counter = outer


def replayed(captured: collections.Counter):
    """Count one replay of a graph whose capture counted ``captured``."""
    launches.update(captured)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):    # sources and headers
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if not already built) and return the library
    path.  Sources compile in parallel; the link writes a temporary file
    that is renamed into place, so a concurrent reader never sees half a
    library."""
    global build_seconds
    out = BUILD_DIR / f"libdpvo_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {name} failed ({proc.returncode}):\n"
                              + log.decode(errors="replace"))
        if errors:
            raise RuntimeError("\n".join(errors))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(lib_tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib_tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str):
    """Raise on a non-zero cudaGetLastError() code from a launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def refuse_autograd(name: str, *tensors):
    """Raise when grad mode is on and an input requires grad.  The kernels
    have no backward: their outputs would carry no gradient, and a training
    path would silently get zero gradients from them."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"CUDA kernel {name} has no backward: call it under "
            "torch.no_grad() or with detached inputs")


def require(t: torch.Tensor, name: str, dtype, shape=None, aligned=False):
    """Wrapper-side argument checks for a kernel input on the card;
    ``aligned``: the kernel reads it in 16-byte chunks."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    if shape is not None:
        if len(shape) != t.dim() or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
