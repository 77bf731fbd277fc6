"""The port's OBJ cook path (niagara_tpu_torch/cooker/cook.py) with its
scene cache, and the cooker's building blocks
(niagara_tpu_torch/cooker/bindings.py), against the JAX package's
(niagara_tpu/cooker/cook.py, bindings.py), on the CPU.  Every comparison
is byte for byte.

* `cook_or_load` on the procedural torus and on tests/test_cooker.py's
  grid mesh written as an .obj (bumped out of its plane): the geometry
  equals the reference's, array for array; `cook_obj_meshes(max_scale=2.0)`
  equals the reference's and moves the ray-tracing LOD.
* The cache: a miss that cooks and writes the file, a hit that cooks
  nothing, a miss after `os.utime` of the source, a miss under another
  CACHE_VERSION; a missing, garbage or foreign file loads as None.  A
  cache file written by either package is a hit in the other.
* `build_meshlets`, `compute_meshlet_bounds`, `simplify`,
  `simplify_scale`, and `ck_generate_vertex_remap` /
  `ck_optimize_vertex_cache` through `get_lib()`, on both meshes.
* The verify skill's probes: a missing, garbage or faceless .obj raises
  IOError in both packages; a degenerate face (`f 1 1 2`) is dropped."""

import os

import numpy as np
import pytest

from niagara_tpu.cooker import bindings as jbindings
from niagara_tpu.cooker import cook as jcook
from niagara_tpu_torch import cooker
from niagara_tpu_torch.cooker import bindings, cook
from test_cooker import make_grid_mesh

MESHES = ["torus", "grid"]


def _grid():
    positions, indices = make_grid_mesh(20)
    positions[:, 2] = np.sin(positions[:, 0] * 7) * 0.2
    return positions, indices.reshape(-1, 3)


def _write_obj(path, positions, faces):
    with open(path, "w") as f:
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in positions)
        f.writelines(f"f {a} {b} {c}\n" for a, b, c in faces + 1)
    return str(path)


@pytest.fixture(scope="module", params=MESHES)
def mesh(request, tmp_path_factory):
    """(name, .obj path, positions [V,3] f32, indices [3T] u32)."""
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "torus":
        positions, _, faces = cooker.procedural_mesh()
        path = cooker.procedural_obj(str(d))
    else:
        positions, faces = _grid()
        path = _write_obj(d / "grid.obj", positions, faces)
    return request.param, path, positions.astype(np.float32), faces.astype(np.uint32).reshape(-1)


def _same_geometry(a, b):
    da, db = cook._geometry_to_dict(a), jcook._geometry_to_dict(b)
    assert set(da) == set(db)
    for k in da:
        x, y = np.asarray(da[k]), np.asarray(db[k])
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


def test_cook_or_load_matches_reference(mesh, tmp_path):
    _, path, *_ = mesh
    g = cook.cook_or_load([path], cache_dir=str(tmp_path / "port"))
    _same_geometry(g, jcook.cook_or_load([path], cache_dir=str(tmp_path / "ref")))
    assert g.meshes.count == 1 and g.meshes.lod_count[0] >= 4 and g.meshlets.count > 10


def test_cook_obj_meshes_max_scale_matches_reference(mesh):
    _, path, *_ = mesh
    g = cook.cook_obj_meshes([path], max_scale=2.0)
    _same_geometry(g, jcook.cook_obj_meshes([path], max_scale=2.0))
    if mesh[0] == "torus":  # its ray-tracing LOD is 10 at scale 1
        assert g.meshes.lod_rt[0] < cook.cook_obj_meshes([path]).meshes.lod_rt[0]


@pytest.fixture
def cooks(monkeypatch):
    """The paths each package's cook_or_load cooked (cook_obj_meshes calls)."""
    seen = {"port": [], "ref": []}
    for name, mod in (("port", cook), ("ref", jcook)):
        def spy(paths, *a, _f=mod.cook_obj_meshes, _seen=seen[name], **kw):
            _seen.append(list(paths))
            return _f(paths, *a, **kw)
        monkeypatch.setattr(mod, "cook_obj_meshes", spy)
    return seen


def test_cache_miss_hit_and_invalidation(mesh, tmp_path, cooks, monkeypatch):
    _, path, *_ = mesh
    obj = str(tmp_path / os.path.basename(path))
    with open(path, "rb") as src, open(obj, "wb") as dst:
        dst.write(src.read())
    cache = tmp_path / (os.path.basename(obj) + ".cache.npz")
    first = cook.cook_or_load([obj], cache_dir=str(tmp_path))
    assert cooks["port"] == [[obj]] and cache.exists()
    _same_geometry(cook.cook_or_load([obj], cache_dir=str(tmp_path)), first)
    assert len(cooks["port"]) == 1, "a second call must load the cache"
    st = os.stat(obj)
    os.utime(obj, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    cook.cook_or_load([obj], cache_dir=str(tmp_path))
    assert len(cooks["port"]) == 2, "a touched source must be cooked again"
    cook.cook_or_load([obj], cache_dir=str(tmp_path))
    assert len(cooks["port"]) == 2
    monkeypatch.setattr(cook, "CACHE_VERSION", cook.CACHE_VERSION + 1)
    cook.cook_or_load([obj], cache_dir=str(tmp_path))
    assert len(cooks["port"]) == 3, "another cache version must cook again"
    with np.load(cache) as data:
        assert data["__meta__"].dtype == np.uint64 and int(data["__meta__"][0]) == cook.CACHE_VERSION
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_load_scene_cache_misses(tmp_path):
    g = cook.cook_or_load([cooker.procedural_obj(str(tmp_path))])
    good = str(tmp_path / "good.cache.npz")
    cook.save_scene_cache(good, g, 0xDEADBEEF12345678)
    _same_geometry(cook.load_scene_cache(good, 0xDEADBEEF12345678), g)
    assert cook.load_scene_cache(good, 0x12345678) is None
    assert cook.load_scene_cache(str(tmp_path / "missing.cache.npz"), 0) is None
    garbage = tmp_path / "garbage.cache.npz"
    garbage.write_bytes(b"not a zip file")
    assert cook.load_scene_cache(str(garbage), 0) is None
    truncated = tmp_path / "truncated.cache.npz"
    truncated.write_bytes(open(good, "rb").read()[:1000])
    assert cook.load_scene_cache(str(truncated), 0xDEADBEEF12345678) is None
    foreign = str(tmp_path / "foreign.cache.npz")
    np.savez(foreign, x=np.zeros(3))
    assert cook.load_scene_cache(foreign, 0) is None


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_cache_files_interchange(mesh, tmp_path, cooks, writer):
    _, path, *_ = mesh
    mods = {"port": cook, "ref": jcook}
    reader = "ref" if writer == "port" else "port"
    written = mods[writer].cook_or_load([path], cache_dir=str(tmp_path))
    read = mods[reader].cook_or_load([path], cache_dir=str(tmp_path))
    assert cooks[writer] == [[path]] and cooks[reader] == [], f"{reader} did not hit {writer}'s cache file"
    port, ref = (written, read) if writer == "port" else (read, written)
    _same_geometry(port, ref)


def _remap(b, flat):
    remap = np.zeros(len(flat), dtype=np.uint32)
    unique = b.get_lib().ck_generate_vertex_remap(b._ptr(remap), b._ptr(flat), len(flat))
    return unique, remap


def _vertex_cache(b, indices, positions):
    out = indices.copy()
    b.get_lib().ck_optimize_vertex_cache(b._ptr(out), len(out), len(positions))
    return out


def _bounds(b, positions, indices):
    mv, mt, vc, tc = jbindings.build_meshlets(positions, indices)
    return np.stack([b.compute_meshlet_bounds(positions, mv[m, :vc[m]], mt[m, :tc[m]]) for m in range(len(vc))])


BLOCKS = {
    "build_meshlets": lambda b, pos, idx, path: b.build_meshlets(pos, idx),
    "build_meshlets_small": lambda b, pos, idx, path: b.build_meshlets(pos, idx, max_vertices=32, max_triangles=16,
                                                                       cone_weight=0.5),
    "compute_meshlet_bounds": lambda b, pos, idx, path: _bounds(b, pos, idx),
    "simplify": lambda b, pos, idx, path: b.simplify(idx, pos, len(idx) // 4),
    "simplify_target_error": lambda b, pos, idx, path: b.simplify(idx, pos, 0, target_error=0.01),
    "simplify_scale": lambda b, pos, idx, path: b.simplify_scale(pos),
    "ck_generate_vertex_remap": lambda b, pos, idx, path: _remap(b, jbindings.load_obj(path)),
    "ck_optimize_vertex_cache": lambda b, pos, idx, path: _vertex_cache(b, idx, pos),
}


def _flat(x):
    """x as a list of (dtype, shape, bytes) or Python values."""
    if isinstance(x, tuple):
        return [v for y in x for v in _flat(y)]
    if isinstance(x, np.ndarray):
        return [(x.dtype.str, x.shape, x.tobytes())]
    return [x]


@pytest.mark.parametrize("block", list(BLOCKS))
def test_cooker_blocks_match_reference(mesh, block):
    _, path, positions, indices = mesh
    ours = BLOCKS[block](bindings, positions, indices, path)
    ref = BLOCKS[block](jbindings, positions, indices, path)
    assert _flat(ours) == _flat(ref)
    if block == "simplify":
        assert 0 < len(ours[0]) <= len(indices) // 4 + 3 and len(ours[0]) % 3 == 0
    if block == "ck_generate_vertex_remap":
        assert 0 < ours[0] < len(ours[1])


@pytest.mark.parametrize("probe", ["missing", "garbage", "faceless"])
def test_bad_obj_raises_ioerror(tmp_path, probe):
    path = tmp_path / f"{probe}.obj"
    if probe == "garbage":
        path.write_bytes(bytes(range(256)) * 8)
    elif probe == "faceless":
        path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n")
    for mod in (cook, jcook):
        with pytest.raises(IOError):
            mod.cook_or_load([str(path)], cache_dir=str(tmp_path / "cache"))


def test_degenerate_faces_are_dropped(tmp_path):
    path = str(tmp_path / "degenerate.obj")
    with open(path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 1 2\nf 1 2 3\nf 2 4 3\nf 3 3 3\n")
    g = cook.cook_or_load([path], build_lods=False)
    _same_geometry(g, jcook.cook_or_load([path], build_lods=False))
    assert int(g.meshes.lod_index_count[0, 0]) == 6 and int(g.meshlets.triangle_count.sum()) == 2
