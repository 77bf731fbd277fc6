"""glTF 2.0 scene loader (niagara_tpu/cooker/gltf.py), JAX-free.

Parses .gltf (JSON + .bin / data URIs) and .glb containers, including
EXT_meshopt_compression bufferViews (cooker/meshopt_codec.py), quantizes
every triangle primitive's vertex streams as the reference does, cooks
each through the port's C++ cooker (`bindings.cook_mesh`), assembles one
`scene.Geometry` (`cook.assemble`), and turns the nodes into `scene.Draws`
(post pass from the material's alphaMode / transmission), a camera, a
sun direction, point lights, materials, texture paths (png/jpg uris
rewritten to a sibling .dds where one exists) and resampled node
animations (`render.animation.AnimationTable`).  `load_scene(...,
cache_dir=...)` keeps a versioned snapshot of all of it, keyed by the
source file's mtime and size.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import zipfile
from dataclasses import dataclass, field

import numpy as np

from ..render.animation import AnimationTable
from ..scene import Draws, Geometry
from ..utils import math3d
from . import bindings, meshopt_codec
from .cook import CACHE_VERSION, _geometry_from_dict, _geometry_to_dict, _hash_file_meta, assemble

COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class SceneData:
    """Everything loadScene produces besides cooked geometry."""

    geometry: Geometry = None
    draws: Draws = None
    materials: dict = None  # diffuse/specular/emissive [NM,...] + texture ids
    texture_paths: list = field(default_factory=list)
    camera_position: np.ndarray = None
    camera_orientation: np.ndarray = None
    camera_fov_y: float = float(np.radians(70.0))
    sun_direction: np.ndarray = None
    lights: dict = None  # position [L,3], range [L], color [L,3], intensity [L]
    animations: object = None  # render.animation.AnimationTable


class _Gltf:
    def __init__(self, path: str):
        self.dir = os.path.dirname(path)
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(0)
            if head == b"glTF":
                self._load_glb(f)
            else:
                self.json = json.load(f)
                self.bin = None
        self._buffers = {}
        self._decoded_views = {}

    def _load_glb(self, f):
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67 or version != 2:
            raise ValueError("bad glb header")
        self.json = None
        self.bin = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            clen, ctype = struct.unpack("<II", hdr)
            data = f.read(clen)
            if ctype == 0x4E4F534A:  # JSON
                self.json = json.loads(data)
            elif ctype == 0x004E4942:  # BIN
                self.bin = data
        if self.json is None:
            raise ValueError("glb without a JSON chunk")

    def buffer(self, index: int) -> bytes:
        if index in self._buffers:
            return self._buffers[index]
        buf = self.json["buffers"][index]
        uri = buf.get("uri")
        if uri is None:
            data = self.bin
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.dir, uri), "rb") as f:
                data = f.read()
        self._buffers[index] = data
        return data

    def view_bytes(self, bv_index: int) -> tuple[bytes, int]:
        """BufferView payload + its base offset within the returned bytes.

        Handles EXT_meshopt_compression (reference scene.cpp:405-471): the
        compressed payload lives in the extension's buffer/offset/length and
        decompresses to count*byteStride bytes replacing the view."""
        bv = self.json["bufferViews"][bv_index]
        ext = bv.get("extensions", {}).get("EXT_meshopt_compression")
        if ext is None:
            return self.buffer(bv["buffer"]), bv.get("byteOffset", 0)
        if bv_index in self._decoded_views:
            return self._decoded_views[bv_index], 0
        off = ext.get("byteOffset", 0)
        comp = self.buffer(ext["buffer"])[off : off + ext["byteLength"]]
        out = meshopt_codec.decode_buffer_view(
            comp, ext["mode"], ext["count"], ext["byteStride"], ext.get("filter", "NONE")
        )
        self._decoded_views[bv_index] = out
        return out, 0

    def accessor(self, index: int) -> np.ndarray:
        """Decode an accessor to float32 (normalized ints scaled) or raw ints
        for SCALAR index data."""
        acc = self.json["accessors"][index]
        n = acc["count"]
        ncomp = TYPE_COUNTS[acc["type"]]
        dtype = COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp

        if "bufferView" not in acc:
            out = np.zeros((n, ncomp), dtype=dtype)
        else:
            bv = self.json["bufferViews"][acc["bufferView"]]
            data, base = self.view_bytes(acc["bufferView"])
            offset = base + acc.get("byteOffset", 0)
            ext = bv.get("extensions", {}).get("EXT_meshopt_compression")
            stride = (ext or bv).get("byteStride", itemsize)
            if stride == itemsize:
                out = np.frombuffer(data, dtype=dtype, count=n * ncomp, offset=offset).reshape(n, ncomp)
            else:
                raw = np.frombuffer(data, dtype=np.uint8)
                idx = offset + stride * np.arange(n)[:, None] + np.arange(itemsize)[None, :]
                out = raw[idx].copy().view(dtype).reshape(n, ncomp)

        # sparse substitution
        if "sparse" in acc:
            out = out.copy()
            sp = acc["sparse"]
            ibv = self.json["bufferViews"][sp["indices"]["bufferView"]]
            idt = COMPONENT_DTYPES[sp["indices"]["componentType"]]
            ioff = ibv.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0)
            sidx = np.frombuffer(self.buffer(ibv["buffer"]), dtype=idt, count=sp["count"], offset=ioff)
            vbv = self.json["bufferViews"][sp["values"]["bufferView"]]
            voff = vbv.get("byteOffset", 0) + sp["values"].get("byteOffset", 0)
            vals = np.frombuffer(self.buffer(vbv["buffer"]), dtype=dtype, count=sp["count"] * ncomp, offset=voff)
            out[sidx] = vals.reshape(sp["count"], ncomp)

        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
            if info.min < 0:
                out = np.maximum(out, -1.0)
        return out


def _node_world_transforms(g: _Gltf) -> list[np.ndarray]:
    nodes = g.json.get("nodes", [])
    local = []
    for node in nodes:
        if "matrix" in node:
            m = np.array(node["matrix"], dtype=np.float32).reshape(4, 4).T  # column-major input
        else:
            t = np.array(node.get("translation", [0, 0, 0]), dtype=np.float32)
            r = np.array(node.get("rotation", [0, 0, 0, 1]), dtype=np.float32)
            s = np.array(node.get("scale", [1, 1, 1]), dtype=np.float32)
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = math3d.quat_to_mat3(r) * s[None, :]
            m[:3, 3] = t
        local.append(m)

    world = [None] * len(nodes)
    parent = [-1] * len(nodes)
    for i, node in enumerate(nodes):
        for c in node.get("children", []):
            parent[c] = i

    def resolve(i):
        if world[i] is not None:
            return world[i]
        if parent[i] < 0:
            world[i] = local[i]
        else:
            world[i] = resolve(parent[i]) @ local[i]
        return world[i]

    for i in range(len(nodes)):
        resolve(i)
    return world


def decompose_transform(m: np.ndarray):
    """World matrix -> (translation, quat xyzw, uniform scale via cbrt of the
    determinant-signed axis scales) — reference scene.cpp:295-340 + draw
    scale derivation :575-577."""
    translation = m[:3, 3].astype(np.float32)

    basis = m[:3, :3]
    det = np.linalg.det(basis)
    sign = -1.0 if det < 0 else 1.0
    scale = np.array([np.linalg.norm(basis[:, k]) for k in range(3)], dtype=np.float32) * sign

    r = basis / np.where(scale == 0, 1, scale)[None, :]
    # matrix -> quaternion (robust Shepperd-style branch)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = np.array([0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s, (r[2, 1] - r[1, 2]) / s])
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = np.array([(r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s, (r[0, 2] - r[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = np.array([(r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s, (r[1, 0] - r[0, 1]) / s])

    uniform_scale = float(np.cbrt(scale[0] * scale[1] * scale[2]))
    return translation, q.astype(np.float32), uniform_scale


def _quantize_primitive(g: _Gltf, prim: dict) -> tuple[np.ndarray, np.ndarray]:
    """Primitive -> (CkVertex array, u32 indices), reference loadVertices
    quantization (scene.cpp:342-403)."""
    attrs = prim["attributes"]
    pos = g.accessor(attrs["POSITION"]).astype(np.float32)
    n = len(pos)
    verts = np.zeros(n, dtype=bindings.VERTEX_DTYPE)
    verts["vx"] = math3d.quantize_half(pos[:, 0])
    verts["vy"] = math3d.quantize_half(pos[:, 1])
    verts["vz"] = math3d.quantize_half(pos[:, 2])

    npacked = np.full(n, 511 | (511 << 10) | (511 << 20), dtype=np.uint32)
    if "NORMAL" in attrs:
        nrm = g.accessor(attrs["NORMAL"]).astype(np.float32)
        npacked = (
            (math3d.quantize_snorm(nrm[:, 0], 10) + 511).astype(np.uint32)
            | ((math3d.quantize_snorm(nrm[:, 1], 10) + 511).astype(np.uint32) << np.uint32(10))
            | ((math3d.quantize_snorm(nrm[:, 2], 10) + 511).astype(np.uint32) << np.uint32(20))
        )
    if "TANGENT" in attrs:
        tan = g.accessor(attrs["TANGENT"]).astype(np.float32)
        oct = math3d.oct_encode(tan[:, :3] / np.maximum(np.linalg.norm(tan[:, :3], axis=1, keepdims=True), 1e-20))
        tp = (
            (math3d.quantize_snorm(oct[:, 0], 8) + 127).astype(np.uint16)
            | ((math3d.quantize_snorm(oct[:, 1], 8) + 127).astype(np.uint16) << np.uint16(8))
        )
        verts["tp"] = tp
        npacked |= np.where(tan[:, 3] >= 0, np.uint32(0), np.uint32(1)) << np.uint32(30)
    verts["np"] = npacked

    if "TEXCOORD_0" in attrs:
        uv = g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
        verts["tu"] = math3d.quantize_half(uv[:, 0])
        verts["tv"] = math3d.quantize_half(uv[:, 1])

    if "indices" in prim:
        indices = g.accessor(prim["indices"]).reshape(-1).astype(np.uint32)
    else:
        indices = np.arange(n, dtype=np.uint32)
    return verts, indices


_DRAW_FIELDS = ("position", "scale", "orientation", "mesh_index",
                "meshlet_visibility_offset", "post_pass", "material_index")
_ANIM_FIELDS = ("draw_index", "light_index", "start_time", "period",
                "key_offset", "key_count", "key_translation", "key_scale",
                "key_rotation")


def _save_scene_data_cache(cache_path: str, sd: SceneData, source_hash: int) -> None:
    """Versioned snapshot of a fully cooked glTF scene — geometry, draws,
    materials, animations (role of the reference's scenecache.cpp, which the
    OBJ path already mirrors in cook.py; the glTF cook is the expensive one:
    per-primitive meshopt decode + clusterize + 16-LOD simplify)."""
    arrays = {f"g_{k}": v for k, v in _geometry_to_dict(sd.geometry).items()}
    arrays.update({f"d_{k}": getattr(sd.draws, k) for k in _DRAW_FIELDS})
    arrays.update({f"m_{k}": v for k, v in sd.materials.items()})
    arrays.update({f"L_{k}": v for k, v in (sd.lights or {}).items()})
    arrays.update({f"a_{k}": np.asarray(getattr(sd.animations, k)) for k in _ANIM_FIELDS})
    arrays["tex_paths"] = np.array(sd.texture_paths, dtype=np.str_)
    has_cam = sd.camera_position is not None
    arrays["camera"] = (
        np.concatenate([np.asarray(sd.camera_position, np.float64).reshape(3),
                        np.asarray(sd.camera_orientation, np.float64).reshape(4),
                        np.float64([sd.camera_fov_y])])
        if has_cam else np.zeros(0, np.float64))
    arrays["sun"] = np.asarray(sd.sun_direction, np.float32)
    arrays["__meta__"] = np.array(
        [CACHE_VERSION, source_hash & 0xFFFFFFFF, (source_hash >> 32) & 0xFFFFFFFF],
        dtype=np.uint64)
    np.savez(cache_path, **arrays)


def _load_scene_data_cache(cache_path: str, source_hash: int) -> SceneData | None:
    if not os.path.exists(cache_path):
        return None
    try:
        with np.load(cache_path) as data:
            meta = data["__meta__"]
            if int(meta[0]) != CACHE_VERSION:
                return None
            if (int(meta[1]) | (int(meta[2]) << 32)) != (source_hash & 0xFFFFFFFFFFFFFFFF):
                return None
            out = SceneData()
            out.geometry = _geometry_from_dict(
                {k[2:]: data[k] for k in data.files if k.startswith("g_")})
            out.draws = Draws(**{k: data[f"d_{k}"] for k in _DRAW_FIELDS})
            out.materials = {k[2:]: data[k] for k in data.files if k.startswith("m_")}
            out.lights = {k[2:]: data[k] for k in data.files if k.startswith("L_")}
            out.animations = AnimationTable(**{k: data[f"a_{k}"] for k in _ANIM_FIELDS})
            out.texture_paths = [str(p) for p in data["tex_paths"]]
            cam = data["camera"]
            if cam.size:
                out.camera_position = cam[:3].astype(np.float32)
                out.camera_orientation = cam[3:7].astype(np.float32)
                out.camera_fov_y = float(cam[7])
            out.sun_direction = data["sun"]
            return out
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


def load_scene(path: str, build_lods: bool = True, cache_dir: str | None = None) -> SceneData:
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        h = _hash_file_meta(path) ^ (0x51F7 if build_lods else 0)
        cache_path = os.path.join(
            cache_dir, os.path.basename(path) + ".scene.npz")
        cached = _load_scene_data_cache(cache_path, h)
        if cached is not None:
            return cached

    g = _Gltf(path)
    out = SceneData()

    # --- cook every primitive as one mesh (reference scene.cpp:517-552) ---
    mesh_prim_range = []  # per glTF mesh: (first cooked mesh index, count)
    prim_material = []  # per cooked mesh: material index or -1
    cooked = []
    for mesh in g.json.get("meshes", []):
        first = len(cooked)
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            verts, indices = _quantize_primitive(g, prim)
            cooked.append(bindings.cook_mesh(verts, indices, build_lods=build_lods))
            prim_material.append(prim.get("material", -1))
        mesh_prim_range.append((first, len(cooked) - first))

    out.geometry = assemble(cooked)

    # --- nodes: draws, camera, lights (reference scene.cpp:554-635) ---
    world = _node_world_transforms(g)
    draw_rows = []
    lights = []
    anim_node_draw = {}
    out.sun_direction = math3d.normalize(np.array([1.0, 1.0, 1.0], dtype=np.float32))

    materials_json = g.json.get("materials", [])

    for i, node in enumerate(g.json.get("nodes", [])):
        if "mesh" in node:
            translation, rotation, scale = decompose_transform(world[i])
            first, count = mesh_prim_range[node["mesh"]]
            for j in range(count):
                mat_idx = prim_material[first + j]
                post_pass = 0
                if mat_idx >= 0:
                    mat = materials_json[mat_idx]
                    if mat.get("alphaMode", "OPAQUE") != "OPAQUE":
                        post_pass = 1
                    if "KHR_materials_transmission" in mat.get("extensions", {}):
                        post_pass = 2
                anim_node_draw[i] = len(draw_rows)
                draw_rows.append(
                    (translation, scale, rotation, first + j, post_pass, max(mat_idx, 0))
                )
        if "camera" in node:
            cam = g.json["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                translation, rotation, _ = decompose_transform(world[i])
                out.camera_position = translation
                out.camera_orientation = rotation
                out.camera_fov_y = float(cam["perspective"].get("yfov", np.radians(70.0)))
        light_ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if light_ext is not None:
            light = g.json["extensions"]["KHR_lights_punctual"]["lights"][light_ext["light"]]
            if light["type"] == "directional":
                out.sun_direction = world[i][:3, 2].astype(np.float32)
            elif light["type"] == "point":
                lights.append(
                    (
                        world[i][:3, 3],
                        float(light.get("range", 0)) or 1e2,
                        np.array(light.get("color", [1, 1, 1]), dtype=np.float32),
                        float(light.get("intensity", 1.0)),
                    )
                )

    n = len(draw_rows)
    out.draws = Draws(
        position=np.array([r[0] for r in draw_rows], dtype=np.float32).reshape(n, 3),
        scale=np.array([r[1] for r in draw_rows], dtype=np.float32),
        orientation=np.array([r[2] for r in draw_rows], dtype=np.float32).reshape(n, 4),
        mesh_index=np.array([r[3] for r in draw_rows], dtype=np.int32),
        meshlet_visibility_offset=np.zeros(n, dtype=np.uint32),
        post_pass=np.array([r[4] for r in draw_rows], dtype=np.int32),
        material_index=np.array([r[5] for r in draw_rows], dtype=np.int32),
    )

    out.lights = {
        "position": np.array([l[0] for l in lights], dtype=np.float32).reshape(len(lights), 3),
        "range": np.array([l[1] for l in lights], dtype=np.float32),
        "color": np.array([l[2] for l in lights], dtype=np.float32).reshape(len(lights), 3),
        "intensity": np.array([l[3] for l in lights], dtype=np.float32),
    }

    # --- materials (reference scene.cpp:639-680) ---
    nm = max(len(materials_json), 1)
    diffuse = np.ones((nm, 4), dtype=np.float32)
    specular = np.zeros((nm, 4), dtype=np.float32)
    emissive = np.zeros((nm, 3), dtype=np.float32)
    textures = np.full((nm, 4), -1, dtype=np.int32)  # albedo, normal, specular, emissive

    def tex_index(info):
        return info["index"] if info else -1

    for i, mat in enumerate(materials_json):
        sg = mat.get("extensions", {}).get("KHR_materials_pbrSpecularGlossiness")
        if sg is not None:
            diffuse[i] = sg.get("diffuseFactor", [1, 1, 1, 1])
            specular[i, :3] = sg.get("specularFactor", [1, 1, 1])
            specular[i, 3] = sg.get("glossinessFactor", 1.0)
            textures[i, 0] = tex_index(sg.get("diffuseTexture"))
            textures[i, 2] = tex_index(sg.get("specularGlossinessTexture"))
        elif "pbrMetallicRoughness" in mat:
            mr = mat["pbrMetallicRoughness"]
            diffuse[i] = mr.get("baseColorFactor", [1, 1, 1, 1])
            specular[i] = [1, 1, 1, 1 - mr.get("roughnessFactor", 1.0)]
            textures[i, 0] = tex_index(mr.get("baseColorTexture"))
            textures[i, 2] = tex_index(mr.get("metallicRoughnessTexture"))
        textures[i, 1] = tex_index(mat.get("normalTexture"))
        textures[i, 3] = tex_index(mat.get("emissiveTexture"))
        emissive[i] = mat.get("emissiveFactor", [0, 0, 0])

    out.materials = {"diffuse": diffuse, "specular": specular, "emissive": emissive, "textures": textures}

    for tex in g.json.get("textures", []):
        img = g.json.get("images", [{}])[tex.get("source", 0)]
        uri = img.get("uri", "")
        # source images ship as png/jpg URIs but the cooked asset set stores
        # pre-compressed DDS next to them (reference scene.cpp:682-705
        # rewrites extensions the same way) — but only when the sibling DDS
        # actually exists; assets genuinely shipping png/jpg keep their path
        # (and the texture loader warns instead of silently falling back)
        dot = uri.rfind(".")
        if dot > 0 and not uri.lower().endswith(".dds"):
            dds_uri = uri[:dot] + ".dds"
            if not g.dir or os.path.exists(os.path.join(g.dir, dds_uri)):
                uri = dds_uri
        out.texture_paths.append(uri)

    out.animations = _load_animations(g, anim_node_draw)
    if cache_path is not None:
        _save_scene_data_cache(cache_path, out, h)
    return out


def _load_animations(g: _Gltf, node_draw: dict):
    """Resample node TRS animation channels to fixed-period keyframes
    (reference scene.cpp:707-834) targeting draw indices."""
    table = AnimationTable.empty()
    anims = g.json.get("animations", [])
    if not anims:
        return table

    period = 1.0 / 30.0
    rows = {"draw_index": [], "light_index": [], "start_time": [], "period": [], "key_offset": [], "key_count": []}
    kt, ks, kr = [], [], []

    for anim in anims:
        # group channels by target node
        per_node = {}
        for ch in anim.get("channels", []):
            tgt = ch.get("target", {})
            node = tgt.get("node")
            if node is None or node not in node_draw:
                continue
            per_node.setdefault(node, []).append(ch)

        for node, channels in per_node.items():
            t0, t1 = np.inf, -np.inf
            samplers = []
            for ch in channels:
                smp = anim["samplers"][ch["sampler"]]
                times = g.accessor(smp["input"]).reshape(-1)
                values = g.accessor(smp["output"])
                t0 = min(t0, float(times[0]))
                t1 = max(t1, float(times[-1]))
                samplers.append((ch["target"]["path"], times, values))
            if not np.isfinite(t0) or t1 <= t0:
                continue

            nk = max(int(np.ceil((t1 - t0) / period)) + 1, 2)
            ts = t0 + np.arange(nk) * period

            base = g.json["nodes"][node]
            tr = np.tile(np.array(base.get("translation", [0, 0, 0]), np.float32), (nk, 1))
            sc = np.full(nk, float(np.mean(base.get("scale", [1, 1, 1]))), np.float32)
            ro = np.tile(np.array(base.get("rotation", [0, 0, 0, 1]), np.float32), (nk, 1))

            for path, times, values in samplers:
                for k, t in enumerate(ts):
                    j = int(np.searchsorted(times, t, side="right") - 1)
                    j = min(max(j, 0), len(times) - 2) if len(times) > 1 else 0
                    if len(times) == 1:
                        v = values[0]
                    else:
                        f = (t - times[j]) / max(times[j + 1] - times[j], 1e-9)
                        f = min(max(f, 0.0), 1.0)
                        v = values[j] * (1 - f) + values[j + 1] * f
                    if path == "translation":
                        tr[k] = v[:3]
                    elif path == "scale":
                        sc[k] = float(np.mean(v[:3]))
                    elif path == "rotation":
                        q = v[:4]
                        ro[k] = q / max(np.linalg.norm(q), 1e-9)

            rows["draw_index"].append(node_draw[node])
            rows["light_index"].append(-1)
            rows["start_time"].append(t0)
            rows["period"].append(period)
            rows["key_offset"].append(len(ks))
            rows["key_count"].append(nk)
            kt.append(tr)
            ks.append(sc)
            kr.append(ro)

    if not rows["draw_index"]:
        return table

    return AnimationTable(
        draw_index=np.array(rows["draw_index"], np.int32),
        light_index=np.array(rows["light_index"], np.int32),
        start_time=np.array(rows["start_time"], np.float32),
        period=np.array(rows["period"], np.float32),
        key_offset=np.array(rows["key_offset"], np.int32),
        key_count=np.array(rows["key_count"], np.int32),
        key_translation=np.concatenate(kt, axis=0).astype(np.float32),
        key_scale=np.concatenate(ks, axis=0).astype(np.float32) if ks and np.ndim(ks[0]) == 1 else np.concatenate(ks).astype(np.float32),
        key_rotation=np.concatenate(kr, axis=0).astype(np.float32),
    )
