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
SOURCES = ("setup.cu", "raster.cu", "shade.cu", "bloom.cu", "trace.cu")
# --fmad=false: no a*b+c contraction, so every kernel rounds op by op like
# its plain torch version; no fast math (IEEE division and sqrt)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# one count per kernel variant: setup / setup_alpha and raster / raster_alpha
# are the two static instances of setup.cu's and raster.cu's kernels;
# raster_window / raster_alpha_window count the same instances launched on a
# band of tile rows (the row_window variant, the sun map's band update);
# bloom_down / bloom_up are bloom.cu's large-level filters, bloom_tail its
# small levels' down and up in one launch, bloom_x2 the expansion; trace /
# trace_alpha the two instances of trace.cu's BVH walk
LAUNCHES = {"setup": 0, "setup_alpha": 0, "raster": 0, "raster_alpha": 0, "raster_window": 0,
            "raster_alpha_window": 0, "shade": 0, "bloom_down": 0, "bloom_up": 0, "bloom_tail": 0, "bloom_x2": 0,
            "trace": 0, "trace_alpha": 0}
build_info = {"seconds": None, "log": "", "path": None}

_lock = threading.Lock()
_lib = None

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


SHADE_STREAMS = 4  # kMaxStreams in csrc/shade.cu


class SetupParams(ctypes.Structure):
    """Mirror of `struct SetupParams` in csrc/setup.cu."""

    _fields_ = [("view", ctypes.c_float * 12), ("p00", ctypes.c_float), ("p11", ctypes.c_float),
                ("znear", ctypes.c_float), ("width", ctypes.c_float), ("height", ctypes.c_float)]


class ShadeStreams(ctypes.Structure):
    """Mirror of `struct ShadeStreams` in csrc/shade.cu: up to SHADE_STREAMS
    record streams (records, count, fragment offset) and their number."""

    _fields_ = [("rec", ctypes.c_void_p * SHADE_STREAMS), ("count", ctypes.c_void_p * SHADE_STREAMS),
                ("off", ctypes.c_int * SHADE_STREAMS), ("n", ctypes.c_int)]


class DownWeights(ctypes.Structure):
    """Mirror of `struct DownWeights` in csrc/bloom.cu: the 6x6 stencil."""

    _fields_ = [("w", ctypes.c_float * 36)]


class UpWeights(ctypes.Structure):
    """Mirror of `struct UpWeights` in csrc/bloom.cu: four 4x4 phase stencils."""

    _fields_ = [("w", ctypes.c_float * 64)]


class X2Weights(ctypes.Structure):
    """Mirror of `struct X2Weights` in csrc/bloom.cu: four 2x2 phase stencils."""

    _fields_ = [("w", ctypes.c_float * 16)]


class TailLevels(ctypes.Structure):
    """Mirror of `struct TailLevels` in csrc/bloom.cu: the tail's levels
    (sizes, offsets of their outputs; `soff` is filled by the launch)."""

    _fields_ = [("n", ctypes.c_int), ("h", ctypes.c_int * 8), ("w", ctypes.c_int * 8),
                ("down_off", ctypes.c_int * 8), ("up_off", ctypes.c_int * 8), ("soff", ctypes.c_int * 8)]


_SIGNATURES = {
    # count, mi, tri_count, xform, draw, mat, post, K, tris, vdata, vertices, alpha
    # (null: no-alpha variant), params, capacity, status, rec, aabb, tri_k, tri_t, valid,
    # counts, stream
    "setup_launch": [P, P, P, P, P, P, P, I, P, P, P, P, SetupParams, I, P, P, P, P, P, P, P, P],
    "setup_group": [],
    # tile_start, tile_order, pair_tri, rec, frag_off, depth_in, vis_in, depth_out, vis_out, width,
    # tiles_x, n_tiles, band_row0, alpha_test, tile_counter, stream
    "raster_launch": [P, P, P, P, I, P, P, P, P, I, I, I, I, I, P, P],
    # vis, width, height, streams, attr, stream
    "shade_launch": [P, I, I, ShadeStreams, P, P],
    # src, c, h, w, out, weights, stream
    "bloom_down_launch": [P, I, I, I, P, DownWeights, P],
    # src, c, h, w, mip, out, oh, ow, weights, stream
    "bloom_up_launch": [P, I, I, I, P, P, I, I, UpWeights, P],
    # src, out, levels, down weights, up weights, stream
    "bloom_tail_launch": [P, P, TailLevels, DownWeights, UpWeights, P],
    # src, c, h, w, out, oh, ow, weights, stream
    "bloom_x2_launch": [P, I, I, I, P, I, I, X2Weights, P],
    # nodes, n_nodes, tlas_base, tris, n_tris, inst, n_inst, uv, alpha, n_alpha, origin, direction, order
    # (null: id order), n_rays, t_min, t_max, max_steps, alpha_test, blocks, counter, occluded, steps, stream
    "trace_launch": [P, I, I, P, I, P, I, P, P, I, P, P, P, I, F, F, I, I, I, P, P, P, P],
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
