"""ctypes bindings for the port's C++ cooker (native/, a copy of the
reference's cook path).

The library is built by g++ at first use into niagara_tpu_torch/build/,
under a name carrying the hash of the sources and flags, so a changed
source rebuilds it and nothing is written outside the port's build
directory.  The dtypes and structures mirror native/cooker.h (and
niagara_tpu/cooker/bindings.py, whose `load_obj` / `cook_mesh` these are).
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
SOURCES = ("cooker.cpp", "meshlet.cpp", "simplify.cpp")
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
            _lib = lib
    return _lib


def _read(ptr, count: int, dtype: np.dtype) -> np.ndarray:
    nbytes = count * dtype.itemsize
    if nbytes == 0:
        return np.empty(0, dtype=dtype)
    raw = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes))
    return np.frombuffer(bytes(raw.contents), dtype=dtype).copy()


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
