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
SOURCES = ("setup.cu", "raster.cu", "shade.cu", "bloom.cu", "trace.cu", "cull.cu", "gbuffer.cu", "shadowmap.cu")
HEADERS = ("lookback.cuh",)  # included by sources: hashed with them
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
# trace_alpha the two instances of trace.cu's BVH walk; draw_cull /
# cluster_cull count cull.cu's two kernels of a cull pass, cluster_order its
# x-ordered metadata gather (one a class group), pyramid_base /
# pyramid_filter the depth pyramid's two; gbuffer counts gbuffer.cu's
# G-buffer encode (every instance of its template); shadow_resolve counts
# shadowmap.cu's sun-map resolve (with or without its blur)
LAUNCHES = {"setup": 0, "setup_alpha": 0, "raster": 0, "raster_alpha": 0, "raster_window": 0,
            "raster_alpha_window": 0, "shade": 0, "bloom_down": 0, "bloom_up": 0, "bloom_tail": 0, "bloom_x2": 0,
            "trace": 0, "trace_alpha": 0, "draw_cull": 0, "cluster_cull": 0, "cluster_order": 0, "pyramid_base": 0,
            "pyramid_filter": 0, "gbuffer": 0, "shadow_resolve": 0}
build_info = {"seconds": None, "log": "", "path": None}

_lock = threading.Lock()
_lib = None

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


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


CULL_TILE = 256  # kTile in csrc/cull.cu: draws or candidate slots a block
CULL_GROUPS = 4  # kMaxGroups
CULL_CLASSES = 8  # kMaxClasses
PYRAMID_LEVELS = 16  # kPyrLevels
PYRAMID_TILE_LEVELS = 5  # kPyrTile = 32: the halvings a pyramid tile builds
PYRAMID_TAIL_MAX = 4096  # kTailMax: texels of the largest level below the tiles


class CullConsts(ctypes.Structure):
    """Mirror of `struct CullConsts` in csrc/cull.cu: ops/cull.CullParams."""

    _fields_ = [("view", ctypes.c_float * 12), ("p00", ctypes.c_float), ("p11", ctypes.c_float),
                ("znear", ctypes.c_float), ("zfar", ctypes.c_float), ("frustum", ctypes.c_float * 4),
                ("lod_target", ctypes.c_float), ("pyramid_w", ctypes.c_float), ("pyramid_h", ctypes.c_float),
                ("culling", ctypes.c_int), ("lod", ctypes.c_int), ("occlusion", ctypes.c_int),
                ("cluster_occlusion", ctypes.c_int), ("cluster_backface", ctypes.c_int), ("post_pass", ctypes.c_int)]


class GroupSpec(ctypes.Structure):
    """Mirror of `struct GroupSpec` in csrc/cull.cu: a cull pass's class
    groups (capacity, x-order constants, key/draw/meshlet outputs) and the
    groups of each class."""

    _fields_ = [("n", ctypes.c_int), ("cap", ctypes.c_int * CULL_GROUPS), ("slot_bits", ctypes.c_int * CULL_GROUPS),
                ("half", ctypes.c_float * CULL_GROUPS), ("hi", ctypes.c_float * CULL_GROUPS),
                ("key", ctypes.c_void_p * CULL_GROUPS), ("draw", ctypes.c_void_p * CULL_GROUPS),
                ("mi", ctypes.c_void_p * CULL_GROUPS), ("group_mask", ctypes.c_uint * CULL_CLASSES)]


class PyramidPlan(ctypes.Structure):
    """Mirror of `struct PyramidPlan` in csrc/cull.cu: the levels' sizes,
    which halve exactly, their nearest-texel tables and where the tiles
    leave them."""

    _fields_ = [(k, ctypes.c_int) for k in ("levels", "in_h", "in_w", "ph", "pw", "lt")] + [
        (k, ctypes.c_int * PYRAMID_LEVELS) for k in ("h", "w", "two_x", "ny", "nx", "uoff")]


class GBufferArgs(ctypes.Structure):
    """Mirror of `struct GBufferArgs` in csrc/gbuffer.cu: the G-buffer's
    inputs, outputs and launch constants."""

    _fields_ = [(k, ctypes.c_void_p) for k in ("attrs", "valid", "depth", "mat_row", "texels", "quads", "mip_rows",
                                               "g0", "g1", "valid_out", "count")] + [
        ("ivp", ctypes.c_float * 16)] + [(k, ctypes.c_int) for k in ("width", "height", "nm", "row_len", "n_tex",
                                                                     "slots", "meta")]


SHADOW_TAPS = 10  # kTaps in csrc/shadowmap.cu: ops/shadow.py SHADOW_BLUR_KERNEL


class ShadowResolveArgs(ctypes.Structure):
    """Mirror of `struct ShadowResolveArgs` in csrc/shadowmap.cu: the
    resolve's inputs, output, count and launch constants."""

    _fields_ = [(k, ctypes.c_void_p) for k in ("depth", "packed", "rows", "lo", "hi", "out", "count")] + [
        ("ivp", ctypes.c_float * 16), ("tap_w", ctypes.c_float * SHADOW_TAPS), ("bias_scale", ctypes.c_float),
        ("znear", ctypes.c_float)] + [(k, ctypes.c_int) for k in ("width", "height", "scale", "sw", "sh", "map_w",
                                                                  "map_h")]


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
    # mesh_row, nr, orientation, scale, position, post_pass, draw_vis, lod_count, lod_offset, nl, vis_offset, D,
    # atlas, atlas_n, atlas_h, atlas_w, consts, late, num_classes, draw_cap, cand_cap, emit, lod, new_vis, bases,
    # entries, new_words, W, counters, status, ticket, stream
    "draw_cull_launch": [P, I, P, P, P, P, P, P, P, I, P, I, P, L, I, I, CullConsts, I, I, I, L, P, P, P, P, P, P, L,
                         P, P, P, P],
    # bases, entries, lod_offset, cull_row, M, xform, vis_words, W, new_words, atlas, atlas_n, atlas_h, atlas_w,
    # consts, late, multi, cand_cap, groups, counters, status, ticket, stream
    "cluster_cull_launch": [P, P, P, P, I, P, P, L, P, P, L, I, I, CullConsts, I, I, I, GroupSpec, P, P, P, P],
    # sorted, draw, mi, counters, group, cap, slot_bits, tri_count, n_tri, xform, mat, post, out mi, tri, xform,
    # draw, mat, post, stream
    "cluster_order_launch": [P, P, P, P, I, I, I, P, I, P, P, P, P, P, P, P, P, P, P],
    # depth, plan, index, u, stream
    "pyramid_base_launch": [P, PyramidPlan, P, P, P],
    # plan, index, u, atlas, stream
    "pyramid_filter_launch": [PyramidPlan, P, P, P, P],
    # args, textured, normal map, quads, stream
    "gbuffer_launch": [GBufferArgs, I, I, I, P],
    # args, blur, stream
    "shadow_resolve_launch": [ShadowResolveArgs, I, P],
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
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
