"""niagara_tpu_torch host side: the JAX-free mirrors equal their originals.

Also holds the parity scene the other tests/test_torch_*.py files share:
the port's small scene (cooker.small_scene_draws: 48 draws of the
procedural mesh in view of the default camera) at 256x128 with
presets.small_capacities().

Importing it builds and loads the JAX package's C++ cooker once under a
file lock (`jax_cooker_ready`): that package's `get_lib` runs make on
first use and writes libcooker.so in place, so a second test process that
loaded it meanwhile got "file too short" and failed every test of its
file.  Every test process collects this module before it runs a test."""

import copy
import fcntl
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

from niagara_tpu import scene as jscene
from niagara_tpu.cooker import cook as jcook
from niagara_tpu.cooker import opacity as jopacity
from niagara_tpu.cooker import synth as jsynth
from niagara_tpu.render import camera as jcamera
from niagara_tpu.render import presets as jpresets
from niagara_tpu.render import textures as jtextures
from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.render import camera, presets, textures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_cooker_ready(timeout: float = 300.0):
    """The JAX package's cooker library, built and loaded under a lock file
    in the temporary directory that every test process of a run takes in
    turn.  A load that meets a library half written by a process outside
    the lock (OSError), or a make that collides with one (CalledProcessError),
    is retried until `timeout` seconds have passed."""
    from niagara_tpu.cooker import bindings as jbindings

    with open(os.path.join(tempfile.gettempdir(), "niagara_tpu_cooker.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + timeout
        while True:
            try:
                return jbindings.get_lib()
            except (OSError, subprocess.CalledProcessError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(2.0)


jax_cooker_ready()

W, H = 256, 128
N_DRAWS = 48
RING = N_DRAWS - 3  # the near ring of small_scene_draws
CAPS = presets.small_capacities()


def parity_scene(cache_dir):
    """(geometry, numpy DeviceScene of the reference's upload) of the small
    scene (cooker.small_scene_draws)."""
    g = cooker.cook_procedural(str(cache_dir))
    return g, jscene.upload(g, cooker.small_scene_draws(g.meshes.count))


def alpha_parity_parts(cache_dir):
    """The inputs of alpha_parity_scene's upload: (geometry with planar
    uvs, draws, materials, opacity masks, the reference's host texture
    table)."""
    g = copy.deepcopy(cooker.cook_procedural(str(cache_dir)))
    jsynth.synthesize_planar_uvs(g, tiles=cooker.synth.SMALL_UV_TILES)
    draws = cooker.small_scene_draws(g.meshes.count)
    materials, mips, mat_idx, post = jsynth.synthesize_materials(draws.count)
    mat_idx[RING], post[RING] = len(mips) - 1, 1
    draws.material_index[:] = mat_idx
    draws.post_pass[:] = post
    masks = jopacity.bake_opacity(g, draws, materials, mips)
    return g, draws, materials, masks, jtextures.build_texture_table(mips=mips)


def alpha_parity_scene(cache_dir):
    """The small scene made textured and alpha-classed by the reference's
    own functions, as bench.py does: planar uvs, synthesize_materials (draws
    7, 15, ..., 47 in the alpha class), opacity masks baked from mip 1, the
    texture table; the near ring (draw 45) joins the alpha class and the uv
    chart has one tile, as in cooker.small_alpha_scene.  Returns (numpy DeviceScene of the
    reference's upload, the reference's host texture table)."""
    g, draws, materials, masks, table = alpha_parity_parts(cache_dir)
    return jscene.upload(g, draws, materials, masks, texture_table=table), table


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    return cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))


def test_assemble_matches_reference(geometry, tmp_path):
    path = cooker.procedural_obj(str(tmp_path))
    from niagara_tpu.cooker import bindings

    flat = bindings.load_obj(path)
    cooked = bindings.cook_mesh(flat, np.arange(len(flat), dtype=np.uint32))
    ours = cooker.assemble([cooked, cooked])  # two meshes: offsets fixed up
    ref = jcook._assemble([cooked, cooked])
    for name in ("vpos", "vnorm", "vtan", "vuv", "indices", "meshlet_data"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)
    for part in ("meshlets", "meshes"):
        for k, v in vars(getattr(ref, part)).items():
            np.testing.assert_array_equal(getattr(getattr(ours, part), k), v, err_msg=f"{part}.{k}")


@pytest.mark.parametrize("n", [1, 1000])
def test_synthesize_draws_matches_reference(n):
    ours, ref = cooker.synthesize_draws(3, draw_count=n), jsynth.synthesize_draws(3, draw_count=n)
    for k, v in vars(ref).items():
        np.testing.assert_array_equal(getattr(ours, k), v, err_msg=k)


def test_upload_matches_reference(geometry):
    draws = cooker.small_scene_draws(geometry.meshes.count)
    ours = scene.upload(geometry, copy.deepcopy(draws))
    ref = jscene.upload(geometry, copy.deepcopy(draws))
    for name in scene._ARRAY_FIELDS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.meshlet_visibility_count == ref.meshlet_visibility_count
    t = scene.from_numpy(ref, "cpu")
    np.testing.assert_array_equal(t.meshlet_vdata.numpy(), ref.meshlet_vdata)
    assert t.num_draws == N_DRAWS


def test_alpha_upload_matches_reference(geometry, tmp_path):
    """The port's own alpha scene (cooker.small_alpha_scene, its texture
    table and upload) equals the reference's: materials, opacity masks,
    texture metadata, every array and static flag.  The caller's geometry
    keeps its uvs (alpha_scene works on a copy)."""
    ref, _ = alpha_parity_scene(tmp_path)
    vuv = geometry.vuv.copy()
    g, draws, materials, masks, mips = cooker.small_alpha_scene(geometry)
    np.testing.assert_array_equal(geometry.vuv, vuv)
    assert not np.array_equal(g.vuv, vuv)
    ours = scene.upload(g, draws, materials, masks, texture_table=textures.build_texture_table(mips))
    for name in scene._ARRAY_FIELDS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in scene._STATIC_FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.has_alpha_masks and ours.texture_slots == (True, False, False, False) and ours.has_texture_meta
    assert (ours.meshlet_alpha[:, 6] > 0).any(), "masks baked"
    np.testing.assert_array_equal(np.nonzero(ours.draw_post_pass)[0], sorted([*range(7, N_DRAWS, 8), RING]))


@pytest.mark.parametrize("settings", [{}, dict(occlusion=False, lod=False, debug_lod_step=2)])
def test_make_cull_params_matches_reference(settings):
    ours, proj = camera.make_cull_params(camera.Camera(), 1920, 1080, 1024, 512, camera.RenderSettings(**settings))
    ref, proj_r = jcamera.make_cull_params(jcamera.Camera(), 1920, 1080, 1024, 512, jcamera.RenderSettings(**settings))
    np.testing.assert_array_equal(proj, proj_r)
    for k, v in vars(ref).items():
        got = getattr(ours, k)
        np.testing.assert_array_equal(np.asarray(got, dtype=np.asarray(v).dtype), v, err_msg=k)


@pytest.mark.parametrize("draws", [1000, 1_000_000])
def test_headline_capacities_match_reference(draws):
    """The reference's budgets, plus, at 1M draws, pair-class budgets and a
    late pair budget raised for the port's mesh: never below the
    reference's values (the implicit tri-capacity fractions for the pair
    classes)."""
    ours, ref = presets.headline_capacities(draws), jpresets.headline_capacities(draws)
    raised = {"late_pair_capacity"} if draws > 300_000 else set()
    assert {k: ours[k] for k in ref if k not in raised} == {k: v for k, v in ref.items() if k not in raised}
    assert all(ours[k] > ref[k] for k in raised)
    extra = set(ours) - set(ref)
    if draws <= 300_000:
        assert not extra
        return
    assert extra == {"pair_class_caps"}
    T = ref["tri_capacity"]
    implicit = (max(T // 2, 256), max(1 << 15, T // 8), max(4096, T // 64), max(512, T // 1024))
    assert all(c >= d for c, d in zip(ours["pair_class_caps"], implicit))


def test_procedural_mesh_closed_with_lod_chain(geometry):
    pos, nrm, faces = cooker.procedural_mesh()
    assert 20_000 <= len(faces) <= 60_000
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all(), "every edge shared by exactly two faces"
    # front faces CCW from outside: positive enclosed volume
    assert np.einsum("ij,ij->i", pos[faces[:, 0]], np.cross(pos[faces[:, 1]], pos[faces[:, 2]])).sum() > 0
    # non-convex: vertex normals facing the center (a convex body around
    # its center has none), and bumps along the tube
    assert (np.einsum("ij,ij->i", nrm, pos) < 0).mean() > 0.2
    assert np.abs(np.linalg.norm(pos, axis=1).max() * 2 - cooker.DIAMETER) < 1e-6
    me = geometry.meshes
    lods = int(me.lod_count[0])
    assert lods >= 8
    tris = me.lod_index_count[0, :lods].astype(np.int64) // 3
    assert tris[0] == len(faces) and (np.diff(tris) < 0).all()
    assert me.lod_meshlet_count[0, lods - 1] < me.lod_meshlet_count[0, 0] // 16


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ml_dtypes'] = None\n"
        "import niagara_tpu_torch, niagara_tpu_torch.render.frame, niagara_tpu_torch.cooker, chip_smoke\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
