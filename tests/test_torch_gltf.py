"""The port's glTF path against the JAX package's: cooker/gltf.py,
cooker/meshopt_codec.py, the cooker's DDS decoder (`bindings.load_dds`
over native/textures.cpp, bc7.cpp, bc6h.cpp), render/textures.py
`load_texture_mips` and render/animation.py.

* `load_scene` on tests/test_gltf.py's glTF (static and animated) and on
  tests/test_meshopt.py's meshopt-compressed .glb: every SceneData array
  byte-identical (cooked geometry, draws, materials, lights, texture
  paths, camera, sun, animation table); and the scene cache's round trip.
* meshopt codecs on seeded buffers: encoded bytes and decoded arrays equal.
* `load_dds` on RGBA8, BC1, BC7 and BC6H (unsigned and signed) files
  written as tests/test_textures.py writes them: mips byte-identical,
  formats equal; `load_texture_mips` equal, its magenta substitution
  counted.
* `evaluate` / `apply_to_draws` on a two-track table: positions, scales
  and draw rows within 1e-6 (lerp: the same f32 ops), orientations within
  2e-6 (slerp's arccos and sin come from XLA's and PyTorch's math
  libraries); draw indices, activity and untouched draws exact."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.cooker import bindings as jbindings
from niagara_tpu.cooker import gltf as jgltf
from niagara_tpu.cooker import meshopt_codec as jmc
from niagara_tpu.cooker.cook import _geometry_to_dict as jgeometry_to_dict
from niagara_tpu.render import animation as janimation
from niagara_tpu.render import textures as jtextures
from niagara_tpu_torch.cooker import bindings, gltf
from niagara_tpu_torch.cooker import meshopt_codec as mc
from niagara_tpu_torch.cooker.cook import _geometry_to_dict
from niagara_tpu_torch.render import animation, textures
from test_gltf import make_test_gltf
from test_meshopt import _write_compressed_glb
from test_textures import write_dds_bc1, write_dds_bc6h, write_dds_bc7, write_dds_rgba


def assert_scene_equal(got, ref):
    """Every array of two SceneData equal byte for byte, dtypes included."""

    def same(a, b, what):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what

    ga, gb = _geometry_to_dict(got.geometry), jgeometry_to_dict(ref.geometry)
    assert ga.keys() == gb.keys()
    for k in ga:
        same(ga[k], gb[k], k)
    for k in jgltf._DRAW_FIELDS:
        same(getattr(got.draws, k), getattr(ref.draws, k), k)
    assert got.materials.keys() == ref.materials.keys() and got.lights.keys() == ref.lights.keys()
    for k in ref.materials:
        same(got.materials[k], ref.materials[k], k)
    for k in ref.lights:
        same(got.lights[k], ref.lights[k], k)
    for k in jgltf._ANIM_FIELDS:
        same(getattr(got.animations, k), getattr(ref.animations, k), k)
    assert got.texture_paths == ref.texture_paths
    same(got.sun_direction, ref.sun_direction, "sun")
    assert (got.camera_position is None) == (ref.camera_position is None)
    if ref.camera_position is not None:
        same(got.camera_position, ref.camera_position, "camera position")
        same(got.camera_orientation, ref.camera_orientation, "camera orientation")
    assert got.camera_fov_y == ref.camera_fov_y


def _source(kind, tmp_path):
    if kind == "meshopt":
        path = str(tmp_path / "quad_meshopt.glb")
        _write_compressed_glb(path)
        return path
    return make_test_gltf(tmp_path, animated=kind == "animated")


@pytest.mark.parametrize("kind", ["static", "animated", "meshopt"])
def test_load_scene_matches_reference(kind, tmp_path):
    path = _source(kind, tmp_path)
    got, ref = gltf.load_scene(path), jgltf.load_scene(path)
    assert_scene_equal(got, ref)
    assert got.draws.count == (1 if kind == "meshopt" else 2)
    assert (got.animations.draw_index.shape[0] > 0) == (kind == "animated")


def test_scene_cache_round_trip(tmp_path):
    path = make_test_gltf(tmp_path, animated=True)
    cache = str(tmp_path / "cache")
    first = gltf.load_scene(path, cache_dir=cache)
    assert [f for f in os.listdir(cache) if f.endswith(".scene.npz")] == ["test.gltf.scene.npz"]
    cached = gltf.load_scene(path, cache_dir=cache)
    ref = jgltf.load_scene(path)
    assert_scene_equal(first, ref)
    assert_scene_equal(cached, ref)
    # a changed source (its mtime) misses the cache and cooks again
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    assert gltf._load_scene_data_cache(os.path.join(cache, "test.gltf.scene.npz"),
                                       gltf._hash_file_meta(path) ^ 0x51F7) is None
    assert_scene_equal(gltf.load_scene(path, cache_dir=cache), ref)


@pytest.mark.parametrize("count,stride", [(1, 4), (255, 16), (1000, 48), (17, 256)])
def test_meshopt_vertex_codec_matches_reference(count, stride):
    rng = np.random.default_rng(count * 1000 + stride)
    v = rng.integers(0, 256, (count, stride), dtype=np.uint8)
    v[count // 2:] = np.cumsum(v[count // 2:], axis=0, dtype=np.uint8)  # small deltas too
    enc = mc.encode_vertex_buffer(v)
    assert enc == jmc.encode_vertex_buffer(v)
    np.testing.assert_array_equal(mc.decode_vertex_buffer(enc, count, stride), jmc.decode_vertex_buffer(enc, count,
                                                                                                       stride))


@pytest.mark.parametrize("seed", [0, 1])
def test_meshopt_index_codecs_and_filters_match_reference(seed):
    rng = np.random.default_rng(seed)
    tris = rng.integers(0, 200, (300, 3)).astype(np.uint32)
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])].reshape(-1)
    enc = mc.encode_index_buffer(tris)
    assert enc == jmc.encode_index_buffer(tris)
    np.testing.assert_array_equal(mc.decode_index_buffer(enc, tris.size), jmc.decode_index_buffer(enc, tris.size))
    seq = np.cumsum(rng.integers(-5, 9, 777)).astype(np.int64)
    seq = (seq - seq.min()).astype(np.uint32)
    enc = mc.encode_index_sequence(seq)
    assert enc == jmc.encode_index_sequence(seq)
    np.testing.assert_array_equal(mc.decode_index_sequence(enc, seq.size), jmc.decode_index_sequence(enc, seq.size))
    for name, shape, dtype in (("oct", (64, 4), np.int8), ("oct", (64, 4), np.int16), ("quat", (64, 4), np.int16),
                               ("exp", (64, 3), np.uint32)):
        raw = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, shape, dtype=dtype, endpoint=True)
        if name == "exp":  # exponents within f32's range
            raw = (raw & np.uint32(0xFFFFFF)) | (rng.integers(-40, 40, shape).astype(np.uint32) << np.uint32(24))
        got = getattr(mc, f"decode_filter_{name}")(raw.copy())
        ref = getattr(jmc, f"decode_filter_{name}")(raw.copy())
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), (name, dtype)


def _write(kind, path):
    rng = np.random.default_rng(len(kind))
    if kind == "rgba8":
        write_dds_rgba(path, rng.integers(0, 256, (24, 40, 4), dtype=np.uint8))
    elif kind == "bc1":
        write_dds_bc1(path, (4, 3), color565=(17, 40, 9))
    elif kind == "bc7":
        payload = rng.integers(0, 256, 16 * 16 * 16, dtype=np.uint8)
        payload[::16][payload[::16] == 0] = 1  # no reserved mode-8 blocks
        write_dds_bc7(path, 64, 64, payload.tobytes())
    else:
        write_dds_bc6h(path, 32, 32, rng.integers(0, 256, 8 * 8 * 16, dtype=np.uint8).tobytes(),
                       signed=kind == "bc6h_signed")


@pytest.mark.parametrize("kind", ["rgba8", "bc1", "bc7", "bc6h", "bc6h_signed"])
def test_load_dds_matches_reference(kind, tmp_path):
    path = str(tmp_path / f"{kind}.dds")
    _write(kind, path)
    (got, fmt), (ref, rfmt) = bindings.load_dds(path), jbindings.load_dds(path)
    assert fmt == rfmt and len(got) == len(ref) >= 1
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_load_texture_mips_matches_reference_and_counts_substitutions(tmp_path):
    names = []
    for kind in ("rgba8", "bc7", "bc1"):
        _write(kind, str(tmp_path / f"{kind}.dds"))
        names.append(f"{kind}.dds")
    names.insert(1, "missing.dds")
    got, substituted = textures.load_texture_mips(names, base_dir=str(tmp_path))
    ref = jtextures.load_texture_mips(names, base_dir=str(tmp_path))
    assert substituted == [str(tmp_path / "missing.dds")]
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got[1][0], [[[255, 0, 255, 255]]])


def _two_track_table(mod):
    """The animated glTF's resampled table plus a second, rotating track of
    draw 1 that starts late and wraps."""
    rot = np.array([[0, 0, 0, 1], [0, 0.3826834, 0, 0.9238795], [0, 0.7071068, 0, 0.7071068],
                    [0, 0, 0.6, -0.8]], np.float32)
    return mod.AnimationTable(
        draw_index=np.array([0, 1], np.int32), light_index=np.array([-1, -1], np.int32),
        start_time=np.array([0.0, 0.4], np.float32), period=np.array([1 / 30, 0.25], np.float32),
        key_offset=np.array([0, 3], np.int32), key_count=np.array([3, 4], np.int32),
        key_translation=np.array([[0, 0, 0], [0, 5, 0], [0, 0, 0], [1, 2, 3], [2, 2, 3], [3, 1, 3], [4, 0, 0]],
                                 np.float32),
        key_scale=np.array([1, 2, 1, 0.5, 1, 1.5, 2], np.float32),
        key_rotation=np.concatenate([np.tile(np.array([[0, 0, 0, 1]], np.float32), (3, 1)), rot]),
    )


@dataclasses.dataclass
class _Draws:
    draw_position: object
    draw_scale: object
    draw_orientation: object
    draw_xform_row: object


def test_animation_matches_reference(tmp_path):
    sd = gltf.load_scene(make_test_gltf(tmp_path, animated=True))
    assert sd.animations.draw_index.tolist() == [0]
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(3, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2, 3).astype(np.float32)
    orient = np.tile(np.array([[0, 0, 0, 1]], np.float32), (3, 1))
    rows = np.concatenate([pos, scale[:, None], orient], axis=1)
    ours = _Draws(*(torch.from_numpy(a.copy()) for a in (pos, scale, orient, rows)))
    ref_scene = _Draws(pos, scale, orient, rows)
    for table, jtable in ((sd.animations, jgltf.load_scene(make_test_gltf(tmp_path, animated=True)).animations),
                          (_two_track_table(animation), _two_track_table(janimation))):
        for t in (0.0, 0.2, 0.55, 1.0, 1.3, 7.77):
            got = animation.evaluate(table, t, "cpu")
            ref = janimation.evaluate(jtable, jnp.float32(t))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0, atol=2e-6)
            moved = animation.apply_to_draws(ours, table, t)
            jmoved = janimation.apply_to_draws(ref_scene, jtable, jnp.float32(t))
            for f in ("draw_position", "draw_scale", "draw_xform_row"):
                np.testing.assert_allclose(getattr(moved, f).numpy(), np.asarray(getattr(jmoved, f)), rtol=0,
                                           atol=2e-6, err_msg=f)
            np.testing.assert_allclose(moved.draw_orientation.numpy(), np.asarray(jmoved.draw_orientation), rtol=0,
                                       atol=2e-6)
            np.testing.assert_array_equal(moved.draw_position[2].numpy(), pos[2])  # no track: untouched
    assert animation.apply_to_draws(ours, animation.AnimationTable.empty(), 1.0) is ours
