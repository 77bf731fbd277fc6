"""Scene cooking, JAX-free.

* `assemble` / `cook_obj_meshes` mirror niagara_tpu/cooker/cook.py
  (`_assemble` :29, `cook_obj_meshes` :138): OBJ -> the port's C++ cooker
  (`bindings`) -> one `Geometry`.
* `procedural_obj` writes the port's stand-in mesh: a closed, non-convex,
  seeded noise-displaced thin torus with smooth normals (57,344
  triangles), so the port needs no external asset.
* `cook_or_load`, `save_scene_cache` and `load_scene_cache` (cook.py:183-227)
  cook OBJ files through a versioned scene cache; cache files
  interchange with the reference's.  `CACHE_VERSION`, `_hash_file_meta`
  and `_geometry_to_dict` / `_geometry_from_dict` (cook.py:20-27,
  152-181) also serve the glTF scene cache (cooker/gltf.py).
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np

from ..config import MAX_LODS
from ..scene import Geometry, Meshes, Meshlets
from ..utils import math3d
from . import bindings

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cache")
CACHE_VERSION = 3


def _hash_file_meta(path: str) -> int:
    """mtime xor size hash of a source file (cook.py:23)."""
    st = os.stat(path)
    return (int(st.st_mtime_ns) ^ (st.st_size << 32)) & 0xFFFFFFFFFFFFFFFF


def _geometry_to_dict(g: Geometry) -> dict:
    """Geometry as flat named arrays (cook.py:152)."""
    out = {"vpos": g.vpos, "vnorm": g.vnorm, "vtan": g.vtan, "vuv": g.vuv, "indices": g.indices,
           "meshlet_data": g.meshlet_data}
    out.update({f"ml_{k}": v for k, v in vars(g.meshlets).items()})
    out.update({f"me_{k}": v for k, v in vars(g.meshes).items()})
    return out


def _geometry_from_dict(d: dict) -> Geometry:
    """Inverse of `_geometry_to_dict` (cook.py:168)."""
    return Geometry(
        vpos=d["vpos"], vnorm=d["vnorm"], vtan=d["vtan"], vuv=d["vuv"], indices=d["indices"],
        meshlet_data=d["meshlet_data"],
        meshlets=Meshlets(**{k[3:]: d[k] for k in d if k.startswith("ml_")}),
        meshes=Meshes(**{k[3:]: d[k] for k in d if k.startswith("me_")}),
    )


def assemble(meshes_cooked: list[dict]) -> Geometry:
    """Concatenate per-mesh cooked arrays into one Geometry, fixing up the
    base-vertex / data / index / meshlet offsets (cook.py:29)."""
    n = len(meshes_cooked)
    vertex_offset = index_offset = meshlet_offset = data_offset = 0
    all_vertices, all_indices, all_meshlets, all_data = [], [], [], []

    mesh_center = np.zeros((n, 3), dtype=np.float32)
    mesh_radius = np.zeros(n, dtype=np.float32)
    mesh_vertex_offset = np.zeros(n, dtype=np.uint32)
    mesh_vertex_count = np.zeros(n, dtype=np.uint32)
    mesh_lod_count = np.zeros(n, dtype=np.uint32)
    mesh_lod_rt = np.zeros(n, dtype=np.uint32)
    lod_index_offset = np.zeros((n, MAX_LODS), dtype=np.uint32)
    lod_index_count = np.zeros((n, MAX_LODS), dtype=np.uint32)
    lod_meshlet_offset = np.zeros((n, MAX_LODS), dtype=np.uint32)
    lod_meshlet_count = np.zeros((n, MAX_LODS), dtype=np.uint32)
    lod_error = np.zeros((n, MAX_LODS), dtype=np.float32)

    for mi, cooked in enumerate(meshes_cooked):
        verts = cooked["vertices"]
        idx = cooked["indices"].astype(np.uint32)
        meshlets = cooked["meshlets"].copy()
        data = cooked["meshlet_data"]
        meshlets["data_offset"] += np.uint32(data_offset)
        meshlets["base_vertex"] += np.uint32(vertex_offset)

        mesh_center[mi] = cooked["center"]
        mesh_radius[mi] = cooked["radius"]
        mesh_vertex_offset[mi] = vertex_offset
        mesh_vertex_count[mi] = len(verts)
        mesh_lod_count[mi] = cooked["lod_count"]
        mesh_lod_rt[mi] = cooked["lod_rt"]
        for li, lod in enumerate(cooked["lods"]):
            lod_index_offset[mi, li] = lod["index_offset"] + index_offset
            lod_index_count[mi, li] = lod["index_count"]
            lod_meshlet_offset[mi, li] = lod["meshlet_offset"] + meshlet_offset
            lod_meshlet_count[mi, li] = lod["meshlet_count"]
            lod_error[mi, li] = lod["error"]

        all_vertices.append(verts)
        all_indices.append(idx + np.uint32(vertex_offset))
        all_meshlets.append(meshlets)
        all_data.append(data)
        vertex_offset += len(verts)
        index_offset += len(idx)
        meshlet_offset += len(meshlets)
        data_offset += len(data)

    vertices = np.concatenate(all_vertices) if all_vertices else np.empty(0, dtype=bindings.VERTEX_DTYPE)
    ml = np.concatenate(all_meshlets) if all_meshlets else np.empty(0, dtype=bindings.MESHLET_DTYPE)

    def field(name):
        return np.ascontiguousarray(ml[name])

    meshlets = Meshlets(
        center=math3d.dequantize_half(field("center")),
        radius=math3d.dequantize_half(field("radius")),
        cone_axis=field("cone_axis"),
        cone_cutoff=field("cone_cutoff"),
        data_offset=field("data_offset"),
        base_vertex=field("base_vertex"),
        vertex_count=field("vertex_count"),
        triangle_count=field("triangle_count"),
        short_refs=field("short_refs"),
    )
    meshes = Meshes(
        center=mesh_center,
        radius=mesh_radius,
        vertex_offset=mesh_vertex_offset,
        vertex_count=mesh_vertex_count,
        lod_count=mesh_lod_count,
        lod_rt=mesh_lod_rt,
        lod_index_offset=lod_index_offset,
        lod_index_count=lod_index_count,
        lod_meshlet_offset=lod_meshlet_offset,
        lod_meshlet_count=lod_meshlet_count,
        lod_error=lod_error,
    )
    dq = math3d.dequantize_half
    return Geometry(
        vpos=np.stack([dq(vertices["vx"]), dq(vertices["vy"]), dq(vertices["vz"])], axis=-1).astype(np.float16),
        vnorm=np.ascontiguousarray(vertices["np"]),
        vtan=np.ascontiguousarray(vertices["tp"]),
        vuv=np.stack([dq(vertices["tu"]), dq(vertices["tv"])], axis=-1).astype(np.float16),
        indices=np.concatenate(all_indices) if all_indices else np.empty(0, dtype=np.uint32),
        meshlet_data=np.concatenate(all_data) if all_data else np.empty(0, dtype=np.uint32),
        meshlets=meshlets,
        meshes=meshes,
    )


def cook_obj_meshes(paths: list[str], max_scale: float = 1.0, build_lods: bool = True) -> Geometry:
    """Cook one mesh per OBJ file, with its LOD chain unless `build_lods`
    is false (cook.py:138)."""
    cooked = []
    for path in paths:
        flat = bindings.load_obj(path)
        indices = np.arange(len(flat), dtype=np.uint32)
        cooked.append(bindings.cook_mesh(flat, indices, max_scale=max_scale, build_lods=build_lods))
    return assemble(cooked)


def save_scene_cache(cache_path: str, geometry: Geometry, source_hash: int) -> None:
    """Versioned snapshot of cooked geometry (cook.py:183): the arrays of
    `_geometry_to_dict` and `__meta__` = [CACHE_VERSION, low and high 32
    bits of the source hash] in one .npz, written under a temporary name
    and renamed, so a concurrent reader sees the old file or the new one."""
    arrays = _geometry_to_dict(geometry)
    arrays["__meta__"] = np.array([CACHE_VERSION, source_hash & 0xFFFFFFFF, source_hash >> 32], dtype=np.uint64)
    tmp = f"{cache_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:  # a file object: np.savez would append .npz to a name
        np.savez(f, **arrays)
    os.replace(tmp, cache_path)


def load_scene_cache(cache_path: str, source_hash: int) -> Geometry | None:
    """The cached geometry, or None when the file is missing, unreadable,
    of another CACHE_VERSION or of another source hash (cook.py:191)."""
    if not os.path.exists(cache_path):
        return None
    try:
        with np.load(cache_path) as data:
            meta = data["__meta__"]
            if int(meta[0]) != CACHE_VERSION:
                return None
            if int(meta[1]) | (int(meta[2]) << 32) != source_hash & 0xFFFFFFFFFFFFFFFF:
                return None
            return _geometry_from_dict({k: data[k] for k in data.files if k != "__meta__"})
    except (OSError, EOFError, KeyError, TypeError, ValueError, zipfile.BadZipFile):
        return None  # a truncated or foreign file is a miss, as in the reference


def cook_or_load(paths: list[str], cache_dir: str | None = None, build_lods: bool = True) -> Geometry:
    """Cook OBJ files through the scene cache in `cache_dir` (none: always
    cook), keyed by the sources' mtime and size (cook.py:209).  As in the
    reference, `build_lods` is not part of the key."""
    source_hash = CACHE_VERSION
    for p in paths:
        source_hash ^= _hash_file_meta(p)
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(cache_dir, "_".join(os.path.basename(p) for p in paths) + ".cache.npz")
        cached = load_scene_cache(cache_path, source_hash)
        if cached is not None:
            return cached
    geometry = cook_obj_meshes(paths, build_lods=build_lods)
    if cache_path is not None:
        save_scene_cache(cache_path, geometry, source_hash)
    return geometry


# the stand-in mesh: a thin torus whose tube radius carries seeded noise,
# sized so the headline frame's steady-state load (emitted draws, live
# triangles, tile pairs) sits near the reference's kitten scene
# (niagara_tpu/render/presets.py:61-70); PERF.md has the sizing runs
RING_SEGMENTS, TUBE_SEGMENTS = 512, 56  # 57,344 triangles
TUBE_RADIUS = 0.12  # relative to the ring radius
TUBE_BUMP = 0.3  # noise amplitude, relative to the tube radius
DIAMETER = 1.8


def procedural_mesh() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded noise-displaced thin torus: (positions [V,3], normals [V,3],
    faces [F,3]) -- closed, genus 1 (so non-convex), centered, DIAMETER
    across, CCW front faces, smooth area-weighted vertex normals."""
    u = np.arange(RING_SEGMENTS) * (2.0 * np.pi / RING_SEGMENTS)
    v = np.arange(TUBE_SEGMENTS) * (2.0 * np.pi / TUBE_SEGMENTS)
    U, V = np.meshgrid(u, v, indexing="ij")
    rng = np.random.default_rng(7)
    fu, fv = rng.integers(1, 7, size=8), rng.integers(1, 5, size=8)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=8)
    bump = sum(np.sin(fu[i] * U + fv[i] * V + phase[i]) / (i + 1) for i in range(8))
    r = TUBE_RADIUS * (1.0 + TUBE_BUMP * bump / np.abs(bump).max())
    ring = 1.0 + r * np.cos(V)
    pos = np.stack([ring * np.cos(U), ring * np.sin(U), r * np.sin(V)], axis=-1).reshape(-1, 3)
    idx = np.arange(U.size).reshape(U.shape)
    nu = np.roll(idx, -1, axis=0)  # next ring segment
    nv, nuv = np.roll(idx, -1, axis=1), np.roll(nu, -1, axis=1)  # next tube segment
    faces = np.concatenate([np.stack([idx, nu, nuv], -1).reshape(-1, 3),
                            np.stack([idx, nuv, nv], -1).reshape(-1, 3)])
    pos -= pos.mean(axis=0)
    pos *= (DIAMETER / 2.0) / np.linalg.norm(pos, axis=1).max()
    fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]], pos[faces[:, 2]] - pos[faces[:, 0]])
    nrm = np.zeros_like(pos)
    for c in range(3):
        np.add.at(nrm, faces[:, c], fn)  # area-weighted vertex normals
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm, faces


def procedural_obj(cache_dir: str = CACHE_DIR) -> str:
    """Write the procedural mesh as an OBJ (v / vn / f v//n) under
    `cache_dir`, named by the hash of its text so a changed mesh never
    reuses a stale file; returns its path."""
    pos, nrm, faces = procedural_mesh()
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in nrm]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces + 1]
    text = "\n".join(lines) + "\n"
    path = os.path.join(cache_dir, f"procedural_{hashlib.sha256(text.encode()).hexdigest()[:12]}.obj")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)  # concurrent writers produce identical files
    return path


def cook_procedural(cache_dir: str = CACHE_DIR) -> Geometry:
    """The procedural mesh cooked through the C++ cooker, with its LOD
    chain, by way of the scene cache in `cache_dir` (bench.py:69's step)."""
    return cook_or_load([procedural_obj(cache_dir)], cache_dir=cache_dir)

