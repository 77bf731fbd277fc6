"""The port's own copy of niagara_tpu/cooker/synth_city.py, unchanged but
for this note and one word of `_tess_box`'s docstring.

Procedural street-canyon city — a Bistro-class glTF stress scene.

The environment ships no Bistro asset, so the glTF path (cooker/gltf.py,
reference loadScene scene.cpp:473-853) was only ever proven on toy
fixtures.  This module generates a .glb with Bistro-LIKE structure:

* **street-canyon layout** (occlusion-heavy): a grid of tessellated
  tower-block buildings separated by narrow streets, camera at street
  level looking down a canyon — most of the scene is hidden behind the
  first rows of facades, which is exactly the workload the two-pass
  occlusion culler exists for;
* **100+ materials, one albedo texture each** (bindless-table stress):
  procedural facade/plank/asphalt/foliage RGBA8 DDS files with full mip
  chains, written next to the .glb (the loader resolves relative uris);
* **alpha-heavy foliage**: street trees with MASK-mode cutout canopies
  riding the alpha post pass + opacity-mask bake, like Bistro's greenery;
* real node TRS transforms, a perspective camera node, u16/u32 indices.

Everything is deterministic (seeded); `ensure_city` writes once and
fingerprints so repeat benchmark runs reuse the cooked scene cache.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

CITY_VERSION = 2


# ---------------------------------------------------------------- geometry

def _tess_box(w: float, d: float, h: float, seg: int, uv_tile: float = 4.0):
    """Axis-aligned box on y in [0, h], footprint w x d centered at origin,
    each face tessellated seg x seg (real vertex load for the meshlet
    clusterizer, like Bistro's facades).  Returns (verts [N,8] pos+normal+uv,
    indices [M] u32)."""
    vs, ns, uvs, idx = [], [], [], []

    def face(origin, du, dv, normal, nu, nv):
        base = len(vs)
        for j in range(nv + 1):
            for i in range(nu + 1):
                p = origin + du * (i / nu) + dv * (j / nv)
                vs.append(p)
                ns.append(normal)
                uvs.append((i / nu * uv_tile, j / nv * uv_tile))
        for j in range(nv):
            for i in range(nu):
                a = base + j * (nu + 1) + i
                b = a + 1
                c = a + (nu + 1)
                dd = c + 1
                idx.extend((a, c, b, b, c, dd))

    x, z = w / 2, d / 2
    O = np.array
    face(O([-x, 0, +z]), O([w, 0, 0]), O([0, h, 0]), O([0, 0, 1.0]), seg, seg)   # +z
    face(O([+x, 0, -z]), O([-w, 0, 0]), O([0, h, 0]), O([0, 0, -1.0]), seg, seg)  # -z
    face(O([+x, 0, +z]), O([0, 0, -d]), O([0, h, 0]), O([1.0, 0, 0]), seg, seg)   # +x
    face(O([-x, 0, -z]), O([0, 0, +d]), O([0, h, 0]), O([-1.0, 0, 0]), seg, seg)  # -x
    face(O([-x, h, +z]), O([w, 0, 0]), O([0, 0, -d]), O([0, 1.0, 0]), 2, 2)       # roof
    verts = np.concatenate(
        [np.asarray(vs, np.float32), np.asarray(ns, np.float32), np.asarray(uvs, np.float32)],
        axis=1,
    )
    return verts, np.asarray(idx, np.uint32)


def _cross_quads(size: float, y0: float, seg: int):
    """Two crossed vertical quads (tree canopy), double-use uv [0,1]."""
    vs, ns, uvs, idx = [], [], [], []
    s = size / 2
    planes = [
        (np.array([-s, y0, 0.0]), np.array([2 * s, 0, 0]), np.array([0, 0, 1.0])),
        (np.array([0.0, y0, -s]), np.array([0, 0, 2 * s]), np.array([1.0, 0, 0])),
    ]
    for origin, du, normal in planes:
        base = len(vs)
        for j in range(seg + 1):
            for i in range(seg + 1):
                p = origin + du * (i / seg) + np.array([0, size * (j / seg), 0])
                vs.append(p)
                ns.append(normal)
                uvs.append((i / seg, 1.0 - j / seg))
        for j in range(seg):
            for i in range(seg):
                a = base + j * (seg + 1) + i
                b, c, d = a + 1, a + seg + 1, a + seg + 2
                idx.extend((a, c, b, b, c, d))
    verts = np.concatenate(
        [np.asarray(vs, np.float32), np.asarray(ns, np.float32), np.asarray(uvs, np.float32)],
        axis=1,
    )
    return verts, np.asarray(idx, np.uint32)


def _quad(w: float, h: float, uv_tile: float = 1.0):
    verts = np.array(
        [[-w / 2, 0, 0, 0, 0, 1, 0, uv_tile],
         [+w / 2, 0, 0, 0, 0, 1, uv_tile, uv_tile],
         [+w / 2, h, 0, 0, 0, 1, uv_tile, 0],
         [-w / 2, h, 0, 0, 0, 1, 0, 0]], np.float32)
    return verts, np.asarray([0, 2, 1, 0, 3, 2], np.uint32)


# ---------------------------------------------------------------- textures

def _mips(img: np.ndarray) -> list[np.ndarray]:
    out = [img]
    while min(out[-1].shape[:2]) > 1:
        m = out[-1]
        out.append(((m[0::2, 0::2].astype(np.uint16) + m[1::2, 0::2] +
                     m[0::2, 1::2] + m[1::2, 1::2]) // 4).astype(np.uint8))
    return out


def _write_dds_rgba_mips(path: str, img: np.ndarray):
    """Legacy uncompressed RGBA8 DDS with a full mip chain (the cooker's
    decoder handles pfFlags 0x40 + 32-bit, textures.cpp)."""
    mips = _mips(img)
    h, w = img.shape[:2]
    header = bytearray(128)
    header[0:4] = b"DDS "
    struct.pack_into("<I", header, 4, 124)
    struct.pack_into("<I", header, 8, 0x21007)  # caps|h|w|pf|mipcount
    struct.pack_into("<I", header, 12, h)
    struct.pack_into("<I", header, 16, w)
    struct.pack_into("<I", header, 28, len(mips))
    struct.pack_into("<I", header, 76, 32)
    struct.pack_into("<I", header, 80, 0x41)  # RGB | ALPHAPIXELS
    struct.pack_into("<I", header, 88, 32)
    with open(path, "wb") as f:
        f.write(bytes(header))
        for m in mips:
            f.write(np.ascontiguousarray(m, np.uint8).tobytes())


def _facade_tex(rng, size: int) -> np.ndarray:
    """Window-grid facade: wall tint + dark window cells, some lit."""
    img = np.zeros((size, size, 4), np.uint8)
    wall = rng.integers(90, 200, 3)
    win = rng.integers(10, 45, 3)
    lit = np.array([230, 200, 120])
    img[..., :3] = wall
    img[..., 3] = 255
    cell = size // 8
    yy, xx = np.mgrid[0:size, 0:size]
    in_win = ((xx % cell) > cell // 4) & ((xx % cell) < 3 * cell // 4) & \
             ((yy % cell) > cell // 4) & ((yy % cell) < 3 * cell // 4)
    wy, wx = yy // cell, xx // cell
    lit_mask = (np.asarray(rng.random((8, 8)) < 0.2))[wy % 8, wx % 8]
    img[..., :3] = np.where(in_win[..., None], np.where(lit_mask[..., None], lit, win), wall)
    return img


def _foliage_tex(rng, size: int) -> np.ndarray:
    """Alpha-cutout leaf blobs (MASK material): ~55% transparent."""
    img = np.zeros((size, size, 4), np.uint8)
    green = rng.integers(40, 120, 3)
    green[1] = rng.integers(100, 220)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    alpha = np.zeros((size, size), bool)
    for _ in range(24):
        cx, cy, r = rng.random(), rng.random(), 0.05 + 0.1 * rng.random()
        alpha |= (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
    img[..., :3] = green
    img[..., 3] = np.where(alpha, 255, 0)
    return img


def _plank_tex(rng, size: int) -> np.ndarray:
    img = np.zeros((size, size, 4), np.uint8)
    base = rng.integers(70, 160, 3)
    yy = np.mgrid[0:size, 0:size][0]
    stripe = ((yy // (size // 8)) % 2) * 25
    img[..., :3] = np.clip(base[None, None] + stripe[..., None], 0, 255)
    img[..., 3] = 255
    return img


def _asphalt_tex(rng, size: int) -> np.ndarray:
    img = np.zeros((size, size, 4), np.uint8)
    noise = rng.integers(55, 90, (size, size, 1))
    img[..., :3] = noise
    img[..., 3] = 255
    return img


# ---------------------------------------------------------------- glb write

def _build_glb(path: str, geoms, mesh_defs, nodes, materials, image_uris, camera):
    """Minimal GLB writer for the subset cooker/gltf.py consumes."""
    blob = bytearray()
    views, accessors = [], []

    def push(arr, target):
        nonlocal blob
        while len(blob) % 4:
            blob += b"\0"
        off = len(blob)
        data = np.ascontiguousarray(arr).tobytes()
        blob += data
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(data),
                      "target": target})
        return len(views) - 1

    def acc(arr, ctype, atype, target):
        v = push(arr, target)
        accessors.append({
            "bufferView": v, "componentType": ctype, "count": int(arr.shape[0]),
            "type": atype,
            "min": np.asarray(arr, np.float64).min(axis=0).tolist() if atype != "SCALAR" else None,
            "max": np.asarray(arr, np.float64).max(axis=0).tolist() if atype != "SCALAR" else None,
        })
        a = accessors[-1]
        if a["min"] is None:
            a.pop("min"), a.pop("max")
        return len(accessors) - 1

    geom_acc = []
    for verts, idx in geoms:
        pa = acc(verts[:, 0:3], 5126, "VEC3", 34962)
        na = acc(verts[:, 3:6], 5126, "VEC3", 34962)
        ta = acc(verts[:, 6:8], 5126, "VEC2", 34962)
        if verts.shape[0] < 65536:
            ia = acc(idx.astype(np.uint16), 5123, "SCALAR", 34963)
        else:
            ia = acc(idx.astype(np.uint32), 5125, "SCALAR", 34963)
        geom_acc.append((pa, na, ta, ia))

    meshes = []
    for geom_i, mat_i in mesh_defs:
        pa, na, ta, ia = geom_acc[geom_i]
        meshes.append({"primitives": [{
            "attributes": {"POSITION": pa, "NORMAL": na, "TEXCOORD_0": ta},
            "indices": ia, "material": mat_i}]})

    gltf = {
        "asset": {"version": "2.0", "generator": f"synth_city v{CITY_VERSION}"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes) + 1))}],
        "nodes": nodes + [{
            "camera": 0,
            "translation": camera["position"],
            "rotation": camera["rotation"],
        }],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": camera["yfov"], "znear": 0.1}}],
        "meshes": meshes,
        "materials": materials,
        "textures": [{"source": i, "sampler": 0} for i in range(len(image_uris))],
        "images": [{"uri": u} for u in image_uris],
        "samplers": [{"magFilter": 9729, "minFilter": 9987, "wrapS": 10497, "wrapT": 10497}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    with open(path, "wb") as f:
        total = 12 + 8 + len(js) + 8 + len(blob)
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))  # JSON
        f.write(js)
        f.write(struct.pack("<II", len(blob), 0x004E4942))  # BIN
        f.write(bytes(blob))


# ---------------------------------------------------------------- the city

def generate_city(out_dir: str, *, blocks: int = 42, seed: int = 11,
                  tex_size: int = 128, facade_seg: int = 32,
                  n_facade: int = 200, n_plank: int = 32, n_ground: int = 16,
                  n_foliage: int = 48, n_trunk: int = 8, n_awning: int = 8) -> str:
    """Write city.glb + its DDS textures into out_dir; returns the glb path.

    Defaults are Bistro-class density (VERDICT r4 #6; reference loadScene
    scope scene.cpp:473-853): a 42x42 street grid = 1,764 tessellated tower
    blocks, ~15.9K draws, ~900 unique cooked meshes / ~200K geometry
    meshlets across their 16-LOD chains, 312 materials / 312 textures
    (facades/planks/asphalt opaque + foliage MASK class riding the alpha
    post pass), ~5K cutout-canopy street trees.  Everything instanced from
    10 base vertex buffers, so the .glb stays small while the cooked
    meshlet/LOD tables carry real scale."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    # --- geometries ---
    dims = [(18, 18, 25), (20, 14, 40), (14, 20, 60),
            (22, 16, 30), (16, 16, 50), (20, 20, 18)]
    geoms = [_tess_box(w, d, h, facade_seg) for (w, d, h) in dims]
    G_CANOPY = len(geoms)
    geoms.append(_cross_quads(5.0, 2.0, 8))
    G_TRUNK = len(geoms)
    geoms.append(_tess_box(0.5, 0.5, 2.4, 2, uv_tile=1.0))
    G_AWNING = len(geoms)
    geoms.append(_quad(8.0, 3.0))
    G_GROUND = len(geoms)
    geoms.append(_tess_box(30.0, 30.0, 0.05, 4, uv_tile=8.0))

    # --- materials + textures ---
    materials, image_uris = [], []

    def add_material(img, alpha=False):
        i = len(materials)
        uri = f"city_tex_{i:03d}.dds"
        _write_dds_rgba_mips(os.path.join(out_dir, uri), img)
        image_uris.append(uri)
        m = {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": i},
                "metallicFactor": 0.0, "roughnessFactor": 0.8}}
        if alpha:
            m["alphaMode"] = "MASK"
            m["alphaCutoff"] = 0.5
            m["doubleSided"] = True
        materials.append(m)
        return i

    facade_mats = [add_material(_facade_tex(rng, tex_size)) for _ in range(n_facade)]
    plank_mats = [add_material(_plank_tex(rng, tex_size)) for _ in range(n_plank)]
    ground_mats = [add_material(_asphalt_tex(rng, tex_size)) for _ in range(n_ground)]
    foliage_mats = [add_material(_foliage_tex(rng, tex_size), alpha=True) for _ in range(n_foliage)]
    trunk_mats = [add_material(_plank_tex(rng, tex_size)) for _ in range(n_trunk)]
    awning_mats = [add_material(_plank_tex(rng, tex_size)) for _ in range(n_awning)]

    # --- glTF meshes: (geometry, material) pairs ---
    mesh_defs, mesh_key = [], {}

    def mesh_of(geom_i, mat_i):
        k = (geom_i, mat_i)
        if k not in mesh_key:
            mesh_key[k] = len(mesh_defs)
            mesh_defs.append(k)
        return mesh_key[k]

    # --- nodes: the street grid ---
    pitch = 30.0
    half = blocks * pitch / 2
    nodes = []

    def node(mesh, pos, scale=1.0, yaw=0.0):
        n = {"mesh": mesh, "translation": [float(p) for p in pos]}
        if scale != 1.0:
            n["scale"] = [float(scale)] * 3
        if yaw:
            n["rotation"] = [0.0, float(np.sin(yaw / 2)), 0.0, float(np.cos(yaw / 2))]
        nodes.append(n)

    for bz in range(blocks):
        for bx in range(blocks):
            cx = bx * pitch - half + pitch / 2
            cz = bz * pitch - half + pitch / 2
            g = int(rng.integers(0, len(dims)))
            m = facade_mats[int(rng.integers(0, len(facade_mats)))]
            node(mesh_of(g, m), (cx, 0.0, cz), scale=float(0.9 + 0.2 * rng.random()),
                 yaw=float(rng.integers(0, 4)) * np.pi / 2)
            node(mesh_of(G_GROUND, ground_mats[(bx + bz) % len(ground_mats)]),
                 (cx, -0.05, cz))
            # street trees along the block's +x street edge
            for t in range(3):
                tx = cx + pitch / 2 - 2.5
                tz = cz - pitch / 2 + (t + 0.5) * pitch / 3
                fm = foliage_mats[int(rng.integers(0, len(foliage_mats)))]
                node(mesh_of(G_CANOPY, fm), (tx, 0.0, tz),
                     scale=float(0.8 + 0.5 * rng.random()),
                     yaw=float(rng.random() * np.pi))
                node(mesh_of(G_TRUNK, trunk_mats[t % len(trunk_mats)]), (tx, 0.0, tz))
            # an awning on the building's -z face
            node(mesh_of(G_AWNING, awning_mats[(bx * 7 + bz) % len(awning_mats)]),
                 (cx, 2.5, cz - pitch / 2 + 4.2))

    # camera: street level, mid-grid, looking down a canyon toward -z
    # (y-axis 180deg turn: -z camera forward axis -> scene -z direction)
    cam_x = -half + pitch * (blocks // 2)  # in a street between block columns
    camera = dict(
        position=[float(cam_x), 1.7, float(half - 2.0)],
        rotation=[0.0, 0.0, 0.0, 1.0],
        yfov=float(np.radians(70.0)),
    )

    glb = os.path.join(out_dir, "city.glb")
    _build_glb(glb, geoms, mesh_defs, nodes, materials, image_uris, camera)
    return glb


def ensure_city(out_dir: str, **kw) -> str:
    """Generate the city once; reuse if the version/params fingerprint
    matches (the DDS + glb set is ~15 MB and fully deterministic)."""
    tag = os.path.join(out_dir, "city.fingerprint")
    fp = json.dumps({"v": CITY_VERSION, **{k: kw[k] for k in sorted(kw)}})
    glb = os.path.join(out_dir, "city.glb")
    if os.path.exists(glb) and os.path.exists(tag) and open(tag).read() == fp:
        return glb
    path = generate_city(out_dir, **kw)
    with open(tag, "w") as f:
        f.write(fp)
    return path
