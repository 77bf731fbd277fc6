"""The procedural glTF city through the port against the JAX reference, on
the reduced city of tests/test_city.py (16 blocks, facade_seg 8, 64^2
textures): cooker/synth_city.py -> .glb parse and C++ cook
(cooker/gltf.py) -> DDS decode (render/textures.load_texture_mips) ->
opacity bake -> texture table -> upload -> two chained 256x128 frames,
textured and alpha-classed, with bloom on.

Exact: the generated .glb and DDS files (byte for byte), the SceneData,
the decoded mips, opacity masks, texture table and device layout,
`scene_capacities` (also on synthetic scenes in each of its windows), and
the frames' FrameState and FrameStats (the port's second frame starts from
the reference's first-frame state).  The visibility buffer, depth and
image carry the reference's FMA-contracted setup and raster floats
(ROADMAP queue C, tests/test_torch_frame.py): the limits below sit just
above what this scene shows.

The street-level camera meets what the torus never gave: triangles seen
exactly edge-on that cross the eye plane.  Their determinant is exactly
0 (in f64 too); the port rounds op by op, as its CUDA kernel, gets 0 and
drops them as back-facing, while XLA's contracted FMAs give the
reference a small positive determinant and keep them (3 to 4 a frame
here).  They cover no pixel center.  So each frame's setup is replayed
through the reference's setup kernel (interpret mode) on the port's
captured inputs: every triangle the port keeps, the reference keeps; each
one only the reference keeps crosses the eye plane and covers no pixel;
tri_count, pair_count and pair_demand_vec differ by exactly those
triangles, every other counter is exact; and since they shift the
compacted fragment ids behind them, vis is compared as (pass, cluster,
triangle) keys.  A last frame gives the most visible material a nonzero
emissive on both sides, so that bloom reaches the image; there the port's
bloom-on and bloom-off images must differ."""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu import scene as jscene
from niagara_tpu.cooker import gltf as jgltf
from niagara_tpu.cooker import opacity as jopacity
from niagara_tpu.cooker import synth_city as jsynth_city
from niagara_tpu.ops import raster as jraster
from niagara_tpu.ops import setup_fused
from niagara_tpu.render import frame as jframe
from niagara_tpu.render import presets as jpresets
from niagara_tpu.render import textures as jtextures
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import scene
from niagara_tpu_torch.cooker import gltf, opacity, synth_city
from niagara_tpu_torch.render import camera, frame, presets, textures
from test_torch_gltf import assert_scene_equal

W, H = 256, 128
CITY = dict(blocks=4, facade_seg=8, tex_size=64)
INVALID = 0x7FFFFFFF
EMISSIVE = np.array([2.0, 1.5, 0.5], np.float32)


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    ours, ref = str(tmp_path_factory.mktemp("city_port")), str(tmp_path_factory.mktemp("city_ref"))
    glb, jglb = synth_city.generate_city(ours, **CITY), jsynth_city.generate_city(ref, **CITY)
    sd, jsd = gltf.load_scene(glb), jgltf.load_scene(jglb)
    mips, substituted = textures.load_texture_mips(sd.texture_paths, base_dir=ours)
    jmips = jtextures.load_texture_mips(jsd.texture_paths, base_dir=ref)
    masks = opacity.bake_opacity(sd.geometry, sd.draws, sd.materials, mips)
    jmasks = jopacity.bake_opacity(jsd.geometry, jsd.draws, jsd.materials, jmips)
    table, jtable = textures.build_texture_table(mips), jtextures.build_texture_table(mips=jmips)
    return SimpleNamespace(
        dirs=(ours, ref), sd=sd, jsd=jsd, mips=mips, jmips=jmips, substituted=substituted, masks=masks,
        jmasks=jmasks, table=table, jtable=jtable,
        ds=scene.upload(sd.geometry, sd.draws, sd.materials, masks, texture_table=table),
        jds=jscene.upload(jsd.geometry, jsd.draws, jsd.materials, jmasks, texture_table=jtable),
    )


def test_generate_city_byte_identical(city):
    ours, ref = city.dirs
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names and "city.glb" in names and len(names) > 300
    for n in names:
        with open(os.path.join(ours, n), "rb") as a, open(os.path.join(ref, n), "rb") as b:
            assert a.read() == b.read(), n


def test_city_scene_matches_reference(city):
    assert_scene_equal(city.sd, city.jsd)
    assert len(city.sd.materials["diffuse"]) >= 100 and len(city.sd.texture_paths) >= 100
    assert (city.sd.draws.post_pass == 1).sum() > 20 and city.sd.camera_position is not None


def test_city_textures_masks_and_layout_match_reference(city):
    assert city.substituted == []
    assert len(city.mips) == len(city.jmips)
    for a, b in zip(city.mips, city.jmips):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(city.masks, city.jmasks)
    assert (city.masks[..., :4] < 65535).any(), "the foliage masks have clear cells"
    for f in ("texels", "mip_offset", "mip_w", "mip_h", "mip_count", "mip_rows", "texels_quad"):
        np.testing.assert_array_equal(getattr(city.table, f), np.asarray(getattr(city.jtable, f)), err_msg=f)
    for f in scene._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(city.ds, f), np.asarray(getattr(city.jds, f)), err_msg=f)
    for f in ("meshlet_visibility_count", "has_alpha_masks", "texture_slots", "has_texture_meta"):
        assert getattr(city.ds, f) == getattr(city.jds, f), f


@pytest.mark.parametrize("total", [None, 5_000, 200_000, 600_000])
def test_scene_capacities_match_reference(city, total):
    """The reduced city (hard-bound window), and synthetic scenes in the
    hard-bound and mid-size windows and past them (headline budgets)."""
    if total is None:
        geometry, draws = city.sd.geometry, city.sd.draws
    else:
        geometry = SimpleNamespace(meshes=SimpleNamespace(lod_meshlet_count=np.array([[7, 3], [13, 5]], np.uint32)))
        n = total // 10
        draws = SimpleNamespace(mesh_index=np.array([0, 1] * (n // 2) + [1] * (n % 2), np.int32), count=n)
    got = presets.scene_capacities(geometry, draws)
    assert got == jpresets.scene_capacities(geometry, draws)
    assert ("giant_capacity" in got) == (total != 600_000)


@pytest.fixture(scope="module")
def frames(city):
    caps = presets.scene_capacities(city.sd.geometry, city.sd.draws)
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=2, raster_interpret=True, **caps)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=2, **caps)
    assert tcfg.bloom and jcfg.bloom and tcfg.giant_capacity == jcfg.giant_capacity == caps["giant_capacity"]
    sd = city.sd
    jp, jsp = jframe.make_frame_inputs(Camera(position=sd.camera_position, orientation=sd.camera_orientation),
                                       RenderSettings(), jcfg, sun_direction=sd.sun_direction)
    tp, tsp = frame.make_frame_inputs(camera.Camera(position=sd.camera_position, orientation=sd.camera_orientation),
                                      camera.RenderSettings(), tcfg, sun_direction=sd.sun_direction)
    jtable, ttable = jax.device_put(city.jtable), textures.to_device(city.table, "cpu")
    jstate = jframe.init_state(city.jds.num_draws, city.jds.meshlet_visibility_count)
    tds = scene.from_numpy(city.ds, "cpu")
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")

    jcp = jframe.make_frame_inputs(Camera(position=sd.camera_position, orientation=sd.camera_orientation),
                                   RenderSettings(), jcfg)[0]

    def keys(vis, setups):
        """Fragment ids as (pass, cluster, triangle) keys; -1 uncovered."""
        out = np.full(vis.shape + (3,), -1, np.int64)
        for p, (off, (tri_k, tri_t)) in enumerate(zip((0, tcfg.tri_capacity), setups)):
            local = vis.astype(np.int64) - off
            hit = (vis != INVALID) & (local >= 0) & (local < len(tri_k))
            out[hit] = np.stack([np.full(hit.sum(), p), tri_k[local[hit]], tri_t[local[hit]]], axis=-1)
        return out

    def replay(jds, capture):
        """The reference's setup kernel on each pass's captured inputs:
        per pass the port's and the reference's (tri_k, tri_t) and the
        reference-only triangles' records and boxes."""
        ours, theirs, extra = [], [], []
        for (tc, cap), st in zip(capture["setup"], capture["setup_out"]):
            n = int(st["count"])
            ours.append((st["tri_k"][:n].numpy(), st["tri_t"][:n].numpy()))
            jtc = jraster.transform_meta_direct(jds, jnp.asarray(tc["draw_id"].numpy()), jnp.asarray(tc["mi"].numpy()),
                                                jnp.asarray(int(tc["count"][0])))
            r = jax.device_get(setup_fused.setup_compact(jtc, jcp, W, H, cap, interpret=True))
            m = int(r["count"])
            rk, rt = np.asarray(r["tri_k"])[:m], np.asarray(r["tri_t"])[:m]
            theirs.append((rk, rt))
            mine = set(zip(ours[-1][0].tolist(), ours[-1][1].tolist()))
            only = np.array([(k, t) not in mine for k, t in zip(rk.tolist(), rt.tolist())], bool)
            assert len(mine) == n and only.sum() == m - n, "every triangle the port keeps, the reference keeps"
            extra.append(dict(rec=np.asarray(r["rec48"])[:m][only],
                              box=np.stack([np.asarray(r[k])[:m][only] for k in ("x0", "y0", "x1", "y1")], -1)))
        return ours, theirs, extra

    def both(jds, tds, jstate, tstate, nobloom=False):
        tstate_in = tstate
        jimg, jfb, jstate, jstats = jframe.render_frame(jds, jstate, jp, jsp, jcfg, textures=jtable)
        capture = {}
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg, textures=ttable, capture=capture)
        ours, theirs, extra = replay(jds, capture)
        ref = dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()})
        ref["keys"] = keys(ref["vis"], theirs)
        dv, vw = frame.state_to_numpy(tstate)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv, vis_words=vw,
                   stats=tstats.to_dict(), extra=extra)
        got["keys"] = keys(got["vis"], ours)
        if nobloom:
            cfg = frame.FrameConfig(width=W, height=H, post_passes=2, bloom=False, **caps)
            got["image_nobloom"] = frame.render_frame(tds, tstate_in, tp, tsp, cfg, textures=ttable)[0].numpy()
        return ref, got, jstate

    out = []
    for _ in range(2):
        ref, got, jstate = both(city.jds, tds, jstate, tstate)
        out.append((ref, got))
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    # the most visible material, emissive on both sides
    visible = city.sd.draws.material_index[out[-1][0]["draw_vis"] > 0]
    mat = int(np.bincount(visible).argmax())
    emissive = np.asarray(city.jds.mat_emissive).copy()
    emissive[mat] = EMISSIVE
    row = np.asarray(city.jds.mat_row).copy()
    row[mat, 8:11] = EMISSIVE
    jds = dataclasses.replace(city.jds, mat_emissive=emissive, mat_row=row)
    tds = dataclasses.replace(tds, mat_emissive=torch.from_numpy(emissive), mat_row=torch.from_numpy(row))
    ref, got, _ = both(jds, tds, jstate, tstate, nobloom=True)
    out.append((ref, got))
    return out


@pytest.mark.parametrize("i", [0, 1, 2])
def test_city_setup_differs_only_by_edge_on_triangles(frames, i):
    """The triangles only the reference keeps: a corner behind the eye
    (view z <= 0, record cols 18/26/34), no pixel center on or inside all
    three edges (cols 0-8) anywhere on the screen."""
    _, got = frames[i]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32) + np.float32(0.5)
    for extra in got["extra"]:
        for r in extra["rec"]:
            assert min(r[18], r[26], r[34]) <= 0.0
            e = [r[3 * j] * xs + r[3 * j + 1] * ys + r[3 * j + 2] for j in range(3)]
            assert not ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)).any(), "an edge-on triangle covers a pixel"


@pytest.mark.parametrize("i", [0, 1, 2])
def test_city_frame_state_and_stats_exact(frames, i):
    ref, got = frames[i]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    # the reference-only edge-on triangles: their count, tiles and classes
    n_extra = sum(len(x["rec"]) for x in got["extra"])
    tiles = sum(int((((b[:, 2] - 1) // 128 - b[:, 0] // 128 + 1) * ((b[:, 3] - 1) // 8 - b[:, 1] // 8 + 1)).sum())
                for b in (x["box"] for x in got["extra"]))
    stats = dict(got["stats"])
    stats["tri_count"] = stats["tri_count"] + n_extra
    stats["pair_count"] = stats["pair_count"] + tiles
    demand = ref["stats"]["pair_demand_vec"].astype(np.int64) - stats["pair_demand_vec"]
    assert (demand >= 0).all() and demand.sum() == n_extra, demand
    stats["pair_demand_vec"] = stats["pair_demand_vec"] + demand
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(stats[k], v.astype(np.int64), err_msg=k)
    s = got["stats"]
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert s[k] == 0, k
    assert not s["pair_drop_vec"].any()
    assert s["visible_draws"] < ref["draw_vis"].size, "the canyon occludes"


@pytest.mark.parametrize("i", [0, 1, 2])
def test_city_frame_images_match(frames, i):
    ref, got = frames[i]
    covered = ref["vis"] != INVALID
    assert 1000 < covered.sum() < covered.size
    flips = (got["keys"] != ref["keys"]).any(axis=-1)
    assert flips.sum() <= 2, f"{flips.sum()} vis ids differ"
    same = covered & ~flips
    np.testing.assert_array_equal(got["depth"][~covered & ~flips], 0.0)
    err = np.abs(got["depth"][same] - ref["depth"][same])
    assert err.max() < 1e-4
    assert np.median(err / ref["depth"][same]) < 3e-6
    assert np.isfinite(got["image"]).all()
    np.testing.assert_allclose(got["image"][~flips], ref["image"][~flips], rtol=0, atol=4.8e-3)
    assert np.abs(got["image"] - ref["image"])[~flips].mean() < 3e-6


def test_city_bloom_reaches_the_image(frames):
    _, got = frames[2]
    # bloom only adds light, and spreads it well past the material's own
    # pixels (measured: 16,175 of 32,768 pixels lifted by over 1e-4, by up
    # to 0.29)
    lift = (got["image"] - got["image_nobloom"]).max(axis=-1)
    assert lift.min() >= 0.0 and lift.max() > 0.1
    assert (lift > 1e-4).sum() > 10_000, "the emissive material blooms"
