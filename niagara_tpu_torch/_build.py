"""Build and bind the CUDA kernels in csrc/.

Each source compiles in its own nvcc process, all started together (the
build takes as long as the slowest source, not the sum: the end-to-end
check builds from scratch inside a fixed time limit that its phases share
as they grow), and the objects link into one shared library with a plain
C interface (no PyTorch headers: seconds, not minutes), loaded with
ctypes.  The library lands in build/ under a name carrying the hash of
the sources and flags, so it is rebuilt exactly when one of them changes.
Pointers go in as `tensor.data_ptr()`, launches go on PyTorch's current
stream, and every C entry returns `cudaGetLastError()`.

`LAUNCHES` counts the kernel launches of each wrapper: a wrapper adds one
right after it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("setup.cu", "raster.cu", "shade.cu")
# --fmad=false: no a*b+c contraction, so every kernel rounds op by op like
# its plain torch version; no fast math (IEEE division and sqrt)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# one count per kernel variant: setup / setup_alpha and raster / raster_alpha
# are the two static instances of setup.cu's scatter and raster.cu's kernel
LAUNCHES = {"setup": 0, "setup_alpha": 0, "raster": 0, "raster_alpha": 0, "shade": 0}
build_info = {"seconds": None, "log": "", "path": None}

_lock = threading.Lock()
_lib = None

P, I = ctypes.c_void_p, ctypes.c_int


class SetupParams(ctypes.Structure):
    """Mirror of `struct SetupParams` in csrc/setup.cu."""

    _fields_ = [("view", ctypes.c_float * 12), ("p00", ctypes.c_float), ("p11", ctypes.c_float),
                ("znear", ctypes.c_float), ("width", ctypes.c_float), ("height", ctypes.c_float)]


_SIGNATURES = {
    # count, mi, tri_count, xform, draw, mat, post, K, tris, vdata, vertices, alpha
    # (null: no-alpha variant), params, capacity, block_counts, block_offsets, total,
    # rec, aabb, flat, stream
    "setup_launch": [P, P, P, P, P, P, P, I, P, P, P, P, SetupParams, I, P, P, P, P, P, P, P],
    # tile_start, pair_tri, rec, frag_off, depth_in, vis_in, depth_out, vis_out, width, tiles_x,
    # n_tiles, alpha_test, stream
    "raster_launch": [P, P, P, I, P, P, P, P, I, I, I, I, P],
    # vis, n_px, width, rec0, off0, count0, rec1, off1, count1, attr, stream
    "shade_launch": [P, I, I, P, I, P, P, I, P, P, P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile(path: str) -> None:
    """nvcc every source in csrc/ at once, then link the objects to `path`."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, s + ".o"), os.path.join(CSRC_DIR, s)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s in SOURCES
        ]
        logs = [p.communicate()[0] for p in procs]
        build_info["log"] = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_info['log']}")
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", out, *(os.path.join(tmp, s + ".o") for s in SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{proc.stdout}{proc.stderr}")
        os.replace(out, path)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use from the sources in csrc/."""
    global _lib
    with _lock:
        if _lib is None:
            path = os.path.join(BUILD_DIR, f"libniagara_kernels_{_digest()}.so")
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                t0 = time.perf_counter()
                _compile(path)
                build_info["seconds"] = time.perf_counter() - t0
            lib_ = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib_, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_info["path"] = path
            _lib = lib_
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def require_cuda(t, name: str) -> None:
    """Wrappers take the plain version only for CPU tensors; anything else
    must be a CUDA tensor, and then the kernel runs or this raises."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")


def expect(t, dtype, tail: tuple, what: str) -> None:
    """Raise unless t has `dtype`, trailing dims `tail` and the device of a
    kernel input (pointers into it go to the kernel unchecked)."""
    if t.dtype != dtype or tuple(t.shape[t.dim() - len(tail):]) != tail or t.device.type != "cuda":
        raise ValueError(f"{what}: expected {dtype} [..., {tail}] on cuda, got {t.dtype} {tuple(t.shape)} on {t.device}")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
