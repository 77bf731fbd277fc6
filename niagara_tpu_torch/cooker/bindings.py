"""ctypes bindings for the port's C++ cooker (native/, a copy of the
reference's cook path, BVH builders and DDS decoder).

The library is built by g++ at first use into niagara_tpu_torch/build/,
under a name carrying the hash of the sources and flags, so a changed
source rebuilds it and nothing is written outside the port's build
directory.  The dtypes and structures mirror native/cooker.h (and
niagara_tpu/cooker/bindings.py, whose `load_obj` / `cook_mesh` /
`build_meshlets` / `compute_meshlet_bounds` / `simplify` / `simplify_scale` /
`load_dds` / `build_bvh` / `build_bvh_boxes` / `refit_bvh_boxes` these are).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.join(_HERE, "native")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
SOURCES = ("cooker.cpp", "meshlet.cpp", "simplify.cpp", "bvh.cpp", "textures.cpp", "bc7.cpp", "bc6h.cpp")
HEADERS = ("cooker.h", "half.h")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None

# CkVertex (16 bytes): fp16 position, packed tangent, 10-10-10 normal, fp16 uv
VERTEX_DTYPE = np.dtype(
    [("vx", np.uint16), ("vy", np.uint16), ("vz", np.uint16), ("tp", np.uint16),
     ("np", np.uint32), ("tu", np.uint16), ("tv", np.uint16)]
)
assert VERTEX_DTYPE.itemsize == 16

# CkMeshlet (24 bytes)
MESHLET_DTYPE = np.dtype(
    [("center", np.uint16, (3,)), ("radius", np.uint16), ("cone_axis", np.int8, (3,)),
     ("cone_cutoff", np.int8), ("data_offset", np.uint32), ("base_vertex", np.uint32),
     ("vertex_count", np.uint8), ("triangle_count", np.uint8), ("short_refs", np.uint8),
     ("padding", np.uint8)]
)
assert MESHLET_DTYPE.itemsize == 24


class _CkLod(ctypes.Structure):
    _fields_ = [("index_offset", ctypes.c_uint32), ("index_count", ctypes.c_uint32),
                ("meshlet_offset", ctypes.c_uint32), ("meshlet_count", ctypes.c_uint32),
                ("error", ctypes.c_float)]


class _CkCooked(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.c_void_p), ("vertex_count", ctypes.c_uint32),
        ("indices", ctypes.c_void_p), ("index_count", ctypes.c_uint32),
        ("meshlets", ctypes.c_void_p), ("meshlet_count", ctypes.c_uint32),
        ("meshlet_data", ctypes.c_void_p), ("meshlet_data_count", ctypes.c_uint32),
        ("center", ctypes.c_float * 3), ("radius", ctypes.c_float),
        ("lod_count", ctypes.c_uint32), ("lod_rt", ctypes.c_uint32),
        ("lods", _CkLod * 16),
    ]


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"libcooker_{_digest()}.so")


def get_lib() -> ctypes.CDLL:
    """The cooker library, built on first use from the sources in native/."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(os.path.join(NATIVE_DIR, s) for s in SOURCES)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)  # concurrent builds produce identical files
            lib = ctypes.CDLL(path)
            lib.ck_load_obj.restype = ctypes.c_uint32
            lib.ck_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
            lib.ck_free_vertices.argtypes = [ctypes.c_void_p]
            lib.ck_cook_mesh.restype = ctypes.POINTER(_CkCooked)
            lib.ck_cook_mesh.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_float, ctypes.c_int]
            lib.ck_free_cooked.argtypes = [ctypes.POINTER(_CkCooked)]
            lib.ck_load_dds.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.ck_load_dds.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            lib.ck_free_rgba.argtypes = [ctypes.c_void_p]
            P, U32, F32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float
            # the cook's stages, exposed for tests (bindings.py:118-165)
            lib.ck_generate_vertex_remap.restype = U32
            lib.ck_generate_vertex_remap.argtypes = [P, P, U32]
            lib.ck_optimize_vertex_cache.restype = None
            lib.ck_optimize_vertex_cache.argtypes = [P, U32, U32]
            lib.ck_meshlet_bound.restype = U32
            lib.ck_meshlet_bound.argtypes = [U32, U32, U32]
            lib.ck_build_meshlets.restype = U32
            lib.ck_build_meshlets.argtypes = [P, U32, P, U32, U32, U32, F32, U32, P, P, P, P]
            lib.ck_compute_meshlet_bounds.restype = None
            lib.ck_compute_meshlet_bounds.argtypes = [P, U32, P, U32, P, U32, P]
            lib.ck_simplify.restype = U32
            lib.ck_simplify.argtypes = [P, P, U32, P, U32, U32, F32, ctypes.POINTER(F32)]
            lib.ck_simplify_scale.restype = F32
            lib.ck_simplify_scale.argtypes = [P, U32]
            lib.ck_build_bvh.restype = U32
            lib.ck_build_bvh.argtypes = [P, U32, P, U32, P, U32, P]
            lib.ck_build_bvh_boxes.restype = U32
            lib.ck_build_bvh_boxes.argtypes = [P, U32, U32, P, U32, P]
            lib.ck_refit_bvh_boxes.restype = None
            lib.ck_refit_bvh_boxes.argtypes = [P, U32, P, U32]
            _lib = lib
    return _lib


def _read(ptr, count: int, dtype: np.dtype) -> np.ndarray:
    nbytes = count * dtype.itemsize
    if nbytes == 0:
        return np.empty(0, dtype=dtype)
    raw = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes))
    return np.frombuffer(bytes(raw.contents), dtype=dtype).copy()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def load_obj(path: str) -> np.ndarray:
    """Parse + quantize an OBJ into a flat triangle-list vertex stream
    (VERTEX_DTYPE, 3 entries per triangle)."""
    lib = get_lib()
    out = ctypes.c_void_p()
    count = lib.ck_load_obj(path.encode(), ctypes.byref(out))
    if count == 0 or not out.value:
        raise IOError(f"failed to load OBJ: {path}")
    arr = _read(out, count, VERTEX_DTYPE)
    lib.ck_free_vertices(out)
    return arr


def cook_mesh(vertices: np.ndarray, indices: np.ndarray, max_scale: float = 1.0, build_lods: bool = True) -> dict:
    """Cook one mesh (dedup, optimize, LOD chain, meshlets); returns a dict
    of numpy arrays + mesh header fields."""
    lib = get_lib()
    vertices = np.ascontiguousarray(vertices, dtype=VERTEX_DTYPE)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    cooked = lib.ck_cook_mesh(ctypes.c_void_p(vertices.ctypes.data), len(vertices),
                              ctypes.c_void_p(indices.ctypes.data), len(indices), max_scale, int(build_lods))
    if not cooked:
        raise RuntimeError("ck_cook_mesh failed")
    c = cooked.contents
    result = {
        "vertices": _read(c.vertices, c.vertex_count, VERTEX_DTYPE),
        "indices": _read(c.indices, c.index_count, np.dtype(np.uint32)),
        "meshlets": _read(c.meshlets, c.meshlet_count, MESHLET_DTYPE),
        "meshlet_data": _read(c.meshlet_data, c.meshlet_data_count, np.dtype(np.uint32)),
        "center": np.array(c.center[:], dtype=np.float32),
        "radius": float(c.radius),
        "lod_count": int(c.lod_count),
        "lod_rt": int(c.lod_rt),
        "lods": [
            {"index_offset": int(l.index_offset), "index_count": int(l.index_count),
             "meshlet_offset": int(l.meshlet_offset), "meshlet_count": int(l.meshlet_count),
             "error": float(l.error)}
            for l in c.lods[: c.lod_count]
        ],
    }
    lib.ck_free_cooked(cooked)
    return result


def build_meshlets(positions: np.ndarray, indices: np.ndarray, max_vertices: int = 64, max_triangles: int = 96,
                   cone_weight: float = 0.25):
    """Meshlets over one index range (bindings.py:231): (vertices [n,
    max_vertices] u32, triangles [n, max_triangles, 3] u8, vertex counts
    [n] u32, triangle counts [n] u32), the output buffers doubled until
    the build fits."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    bound = lib.ck_meshlet_bound(len(indices), max_vertices, max_triangles)
    while True:
        mv = np.zeros((bound, max_vertices), dtype=np.uint32)
        mt = np.zeros((bound, max_triangles * 3), dtype=np.uint8)
        vc = np.zeros(bound, dtype=np.uint32)
        tc = np.zeros(bound, dtype=np.uint32)
        n = lib.ck_build_meshlets(_ptr(positions), len(positions), _ptr(indices), len(indices), max_vertices,
                                  max_triangles, cone_weight, bound, _ptr(mv), _ptr(mt), _ptr(vc), _ptr(tc))
        if n != 0xFFFFFFFF:
            return mv[:n], mt[:n].reshape(n, max_triangles, 3), vc[:n], tc[:n]
        bound *= 2


def compute_meshlet_bounds(positions: np.ndarray, meshlet_vertices: np.ndarray,
                           meshlet_triangles: np.ndarray) -> np.ndarray:
    """One meshlet's bounding sphere and backface cone before quantization
    (bindings.py:252): f32 [cx, cy, cz, radius, ax, ay, az, cutoff]."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    mv = np.ascontiguousarray(meshlet_vertices, dtype=np.uint32)
    mt = np.ascontiguousarray(meshlet_triangles, dtype=np.uint8).reshape(-1)
    out = np.zeros(8, dtype=np.float32)
    lib.ck_compute_meshlet_bounds(_ptr(positions), len(positions), _ptr(mv), len(mv), _ptr(mt), len(mt) // 3,
                                  _ptr(out))
    return out


def simplify(indices: np.ndarray, positions: np.ndarray, target_index_count: int, target_error: float = 0.1):
    """QEM simplification toward `target_index_count` indices
    (bindings.py:264): (indices u32, the largest collapse error in
    unit-extent units)."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    dst = np.zeros_like(indices)
    err = ctypes.c_float()
    n = lib.ck_simplify(_ptr(dst), _ptr(indices), len(indices), _ptr(positions), len(positions), target_index_count,
                        target_error, ctypes.byref(err))
    return dst[:n], float(err.value)


def simplify_scale(positions: np.ndarray) -> float:
    """The mesh's extent (the largest side of its box), which turns a
    simplification error into world units (bindings.py:278)."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    return float(lib.ck_simplify_scale(_ptr(positions), len(positions)))


def load_dds(path: str) -> tuple[list[np.ndarray], int]:
    """Decode a DDS texture (BC1-5, BC6H, BC7 or RGBA8) to RGBA8 mips
    (bindings.py:364).  Returns (mips: list of [h,w,4] uint8, format 1..9)."""
    lib = get_lib()
    info = np.zeros(4, dtype=np.uint32)
    ptr = lib.ck_load_dds(path.encode(), ctypes.c_void_p(info.ctypes.data))
    if not ptr:
        raise IOError(f"failed to load DDS (unsupported format?): {path}")
    w, h, levels, fmt = (int(v) for v in info)
    dims = []
    for _ in range(levels):
        dims.append((h, w))
        w, h = max(w // 2, 1), max(h // 2, 1)
    flat = _read(ptr, sum(a * b for a, b in dims) * 4, np.dtype(np.uint8))
    lib.ck_free_rgba(ptr)
    out, off = [], 0
    for mh, mw in dims:
        out.append(flat[off * 4:(off + mw * mh) * 4].reshape(mh, mw, 4))
        off += mw * mh
    return out, fmt


def _grow(build, count: int, min_cap: int):
    """Call build(nodes, cap, order) with a node buffer doubled until the
    builder's node count fits (it returns ~0 when it does not)."""
    cap = max(2 * count + 8, min_cap)
    while True:
        nodes = np.zeros((cap, 8), dtype=np.float32)
        order = np.zeros(count, dtype=np.uint32)
        n = build(nodes, cap, order)
        if n != 0xFFFFFFFF:
            return nodes[:n], order
        cap *= 2


def build_bvh(positions: np.ndarray, indices: np.ndarray):
    """Skip-pointer BVH over a triangle soup (bindings.py:284): (nodes
    [N, 8] f32 -- box min/max, skip and leaf as int32 bits -- and the
    leaf-order triangle permutation [T] u32)."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    return _grow(lambda nodes, cap, order: lib.ck_build_bvh(_ptr(positions), len(positions), _ptr(indices),
                                                            len(indices), _ptr(nodes), cap, _ptr(order)),
                 len(indices) // 3, 64)


def _boxes(boxes_min: np.ndarray, boxes_max: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate([np.ascontiguousarray(boxes_min, np.float32),
                                                np.ascontiguousarray(boxes_max, np.float32)], axis=-1), np.float32)


def build_bvh_boxes(boxes_min: np.ndarray, boxes_max: np.ndarray, max_leaf: int = 1):
    """Skip-pointer BVH over boxes, the TLAS level (bindings.py:314):
    (nodes [N, 8] f32, the leaf-order box permutation [B] u32); a leaf's
    word is first * 16 + count over that order."""
    lib = get_lib()
    boxes = _boxes(boxes_min, boxes_max)
    if len(boxes) == 0:
        return np.zeros((0, 8), np.float32), np.zeros(0, np.uint32)
    return _grow(lambda nodes, cap, order: lib.ck_build_bvh_boxes(_ptr(boxes), len(boxes), max_leaf, _ptr(nodes),
                                                                  cap, _ptr(order)),
                 len(boxes), 64)


def refit_bvh_boxes(nodes: np.ndarray, boxes_min: np.ndarray, boxes_max: np.ndarray) -> np.ndarray:
    """A copy of a build_bvh_boxes tree with its boxes recomputed bottom-up
    from new leaf boxes given in the build's leaf order, topology kept
    (bindings.py:344, the reference's per-frame MODE_UPDATE refit)."""
    lib = get_lib()
    nodes = np.ascontiguousarray(nodes, np.float32).copy()
    boxes = _boxes(boxes_min, boxes_max)
    if len(nodes):
        lib.ck_refit_bvh_boxes(_ptr(nodes), len(nodes), _ptr(boxes), len(boxes))
    return nodes
