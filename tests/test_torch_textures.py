"""Textures, materials and opacity masks of niagara_tpu_torch against the
reference (render/textures.py, cooker/synth.py, cooker/opacity.py and the
material branch of ops/shade.py).

* synthesize_materials, synthesize_planar_uvs, bake_mesh_masks and
  bake_opacity: equal array for array (host numpy, copied).
* build_texture_table: every array equal, on the benchmark's materials, on
  a chain that does not floor-halve (its tail is rebuilt), under a pool
  budget that drops mips and under a quad budget that leaves out the quad
  pool.
* sample: at seeded uv, mip and texture ids, on the mip-row and the
  analytic (`meta`) addressing paths, with and without the quad pool.
  Nearest and bilinear sampling are equal bit for bit (nearest holds the
  integer texel addresses equal; the bilinear weights round alike).
* gbuffer_from_attrs: seeded attribute planes (normals, uv, material,
  post class, uv derivative) through the textured branch with its
  shade-time alpha discard, through the multi-material untextured branch
  and with the one-material default table (the port fetches all three by
  one per-pixel gather; the reference by a masked sum or a broadcast).
  valid equal; g0/g1 within 1.2e-7 (measured 5.96e-8, one ulp at 1: the
  reference's sRGB pow and log2 run on XLA's CPU math library, the
  port's on PyTorch's)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu import scene as jscene
from niagara_tpu.cooker import opacity as jopacity
from niagara_tpu.cooker import synth as jsynth
from niagara_tpu.ops import shade as jshade
from niagara_tpu.render import textures as jtextures
from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.cooker import opacity
from niagara_tpu_torch.ops import shade
from niagara_tpu_torch.render import textures


@pytest.fixture(scope="module")
def materials():
    return cooker.synthesize_materials(1000), jsynth.synthesize_materials(1000)


def test_synthesize_materials_matches_reference(materials):
    (m, mips, idx, post), (rm, rmips, ridx, rpost) = materials
    for k in rm:
        np.testing.assert_array_equal(m[k], rm[k], err_msg=k)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(post, rpost)
    assert post.sum() == 125 and len(mips) == len(rmips) == 8
    for a, b in zip(mips, rmips):
        assert len(a) == len(b) == 9
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_planar_uvs_and_bake_match_reference(tmp_path):
    g = cooker.cook_procedural(str(tmp_path))
    ours, ref = copy.deepcopy(g), copy.deepcopy(g)
    cooker.synthesize_planar_uvs(ours)
    jsynth.synthesize_planar_uvs(ref)
    np.testing.assert_array_equal(ours.vuv, ref.vuv)
    draws = cooker.synthesize_draws(g.meshes.count, draw_count=64)
    materials, mips, idx, post = cooker.synthesize_materials(64)
    draws.material_index[:], draws.post_pass[:] = idx, post
    got = opacity.bake_opacity(ours, draws, materials, mips)
    np.testing.assert_array_equal(got, jopacity.bake_opacity(ref, draws, materials, mips))
    assert (got[..., 6] > 0).any() and (got[..., :4] < 65535).any(), "masks with clear cells"
    rng = np.random.default_rng(3)
    uv = rng.uniform(-2, 3, (40, 2)).astype(np.float32)
    tris = rng.integers(0, 40, (200, 3))
    np.testing.assert_array_equal(opacity.bake_mesh_masks(uv, tris, mips[7][1]),
                                  jopacity.bake_mesh_masks(uv, tris, mips[7][1]))


def _odd_chain():
    """A 6x10 texture with a numpy [::2] pyramid (ceil-halving: 3x5, 2x3,
    1x2, 1x1): not floor-halving from 3x5 on."""
    base = np.random.default_rng(4).integers(0, 256, (6, 10, 4), dtype=np.uint8)
    chain = [base]
    while chain[-1].shape[0] > 1 or chain[-1].shape[1] > 1:
        chain.append(chain[-1][::2, ::2])
    return chain


@pytest.mark.parametrize("case", ["bench", "odd", "budget", "no_quads"])
def test_texture_table_matches_reference(materials, case):
    mips = materials[0][1]
    kw = {}
    if case == "odd":
        mips = [_odd_chain()] + mips[:2]
    elif case == "budget":
        kw = dict(budget_bytes=300_000)
    elif case == "no_quads":
        kw = dict(quad_budget_bytes=1 << 20)
    ours = textures.build_texture_table(mips, **kw)
    ref = jtextures.build_texture_table(mips=mips, **kw)
    for f in ("texels", "mip_offset", "mip_w", "mip_h", "mip_count", "mip_rows", "texels_quad"):
        a, b = getattr(ours, f), getattr(ref, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if case == "budget":
        assert ours.mip_count[1] < 9, "the budget dropped mips"
    if case == "no_quads":
        assert ours.texels_quad is None


def _sample_inputs(table, n=4096, seed=6):
    rng = np.random.default_rng(seed)
    tex_id = rng.integers(0, len(table.mip_count), n).astype(np.int32)
    uv = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mip = rng.integers(-1, 16, n).astype(np.int32)
    return tex_id, uv, mip


@pytest.mark.parametrize("quads", [True, False])
@pytest.mark.parametrize("meta", [False, True])
@pytest.mark.parametrize("bilinear", [True, False])
def test_sample_matches_reference(materials, quads, meta, bilinear):
    mips = [_odd_chain()] + materials[0][1]
    host = textures.build_texture_table(mips, quad_budget_bytes=None if quads else 0)
    jtab = jax.device_put(jtextures.build_texture_table(mips=mips, quad_budget_bytes=None if quads else 0))
    ttab = textures.to_device(host, "cpu")
    tex_id, uv, mip = _sample_inputs(host)
    jmeta = tmeta = None
    if meta:
        t = np.clip(tex_id, 0, len(host.mip_count) - 1)
        cols = [host.mip_offset[t, 0], host.mip_w[t, 0], host.mip_h[t, 0], host.mip_count[t]]
        jmeta = tuple(jnp.asarray(c.astype(np.int32)) for c in cols)
        tmeta = tuple(torch.from_numpy(c.astype(np.int32)) for c in cols)
    ref = np.asarray(jtextures.sample(jtab, jnp.asarray(tex_id), jnp.asarray(uv), jnp.asarray(mip),
                                      bilinear=bilinear, meta=jmeta))
    got = textures.sample(ttab, torch.from_numpy(tex_id), torch.from_numpy(uv), torch.from_numpy(mip),
                          bilinear=bilinear, meta=tmeta).numpy()
    assert got.shape == ref.shape == (len(uv), 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got[:, 0])) > 50


def test_select_mip_matches_reference():
    rng = np.random.default_rng(8)
    duv = (10.0 ** rng.uniform(-8, 2, 10_000)).astype(np.float32)
    area = rng.choice([1.0, 4.0, 65536.0, 1 << 24], 10_000).astype(np.float32)
    ref = np.asarray(jtextures.select_mip_from_area(jnp.asarray(duv), jnp.asarray(area)))
    got = textures.select_mip_from_area(torch.from_numpy(duv), torch.from_numpy(area)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) > 8


def _attrs(h=16, w=64, seed=9):
    """Seeded attribute planes [h, w, 13]: channels 0-2 normal, 3-4 uv, 7
    material (0-7), 8 post class, 12 uv derivative; the rest unread."""
    rng = np.random.default_rng(seed)
    a = np.zeros((h, w, 13), np.float32)
    a[..., 0:3] = rng.normal(size=(h, w, 3))
    a[..., 3:5] = rng.uniform(-2, 4, (h, w, 2))
    a[..., 7] = rng.integers(0, 8, (h, w))
    a[..., 8] = a[..., 7] == 7
    a[..., 12] = 10.0 ** rng.uniform(-7, -2, (h, w))
    return a, rng.random((h, w)) < 0.9


@pytest.mark.parametrize("textured", [True, False, pytest.param(None, id="one_material")])
def test_gbuffer_materials_match_reference(tmp_path, textured):
    """textured None: the default one-material table (the opaque frame's),
    every id 0."""
    g = cooker.cook_procedural(str(tmp_path))
    attrs, valid = _attrs()
    if textured is None:
        np_scene = jscene.upload(g, cooker.synthesize_draws(g.meshes.count, 64))
        attrs[..., 7:9] = 0.0
    else:
        g, draws, materials, masks, mips = cooker.alpha_scene(g, cooker.synthesize_draws(g.meshes.count, 64))
        table = textures.build_texture_table(mips)
        materials = dict(materials, diffuse=np.random.default_rng(2).uniform(0.2, 1, (8, 4)).astype(np.float32))
        np_scene = jscene.upload(g, draws, materials, masks, texture_table=table)
    jtab = jax.device_put(jtextures.build_texture_table(mips=mips)) if textured else None
    ttab = textures.to_device(table, "cpu") if textured else None
    ref = jshade.gbuffer_from_attrs(jnp.asarray(attrs), jnp.asarray(valid), jax.device_put(np_scene), textures=jtab)
    got = shade.gbuffer_from_attrs(torch.from_numpy(attrs), torch.from_numpy(valid),
                                   scene.from_numpy(np_scene, "cpu"), textures=ttab)
    r0, r1, rvalid = (np.asarray(x) for x in ref)
    g0, g1, gvalid = (x.numpy() for x in got)
    np.testing.assert_array_equal(gvalid, rvalid)
    if textured:
        assert (valid & ~rvalid).sum() > 50, "the shade-time alpha test discards post pixels"
    else:
        np.testing.assert_array_equal(rvalid, valid)
    np.testing.assert_allclose(g0, r0, rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(g1, r1, rtol=0, atol=1.2e-7)
