"""Normal maps in niagara_tpu_torch's G-buffer against the JAX reference
(niagara_tpu/ops/shade.py:224-257, 297-325): the screen-space tangent
frame on seeded planes, and gbuffer_from_attrs with a normal-mapped
material on the reference's quad scene (tests/test_textured_fast.py:174-206
rebuilt here), fed the same attribute planes, depth and inverse
view-projection (the reference's frame_core, kernels in interpret mode).

Tolerances.  XLA:CPU contracts the reference's cross products and its
`clip @ ivp.T` into FMAs and computes rsqrt where the port takes one
square root and one division, so the frames differ in the last bits: on
the planes the tangent and bitangent agree within 1e-6 absolute (at most
2.4e-7 measured); through the quad's G-buffer g1 within 1e-6 (at most
6.0e-8 measured, on both maps), g0 and the valid mask exactly.  The port's own frame recovers the
analytic tangent of the flat quad (the reference's analytic check, dots of
the mapped normal with the expected one above 0.995 at 95% of the
interior pixels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu import scene as jscene
from niagara_tpu.cooker.cook import cook_obj_meshes
from niagara_tpu.cooker.synth import synthesize_draws
from niagara_tpu.ops import shade as jshade
from niagara_tpu.render import frame as jframe
from niagara_tpu.render import textures as jtextures
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.ops import cullmath, shade
from niagara_tpu_torch.render import textures

INVALID = 0x7FFFFFFF
QUAD = ("v -2 -2 0\nv 2 -2 0\nv 2 2 0\nv -2 2 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
# one draw of two triangles
CFG = jframe.FrameConfig(width=128, height=128, max_groups=8, cmd_capacity=1 << 4, cluster_capacity=1 << 6,
                         pair_capacity=1 << 10, tri_capacity=1 << 8, raster_interpret=True, post_passes=2)


# the reference's frame_core, compiled once for both maps (the scene's
# shapes and static fields do not depend on the texture)
_core = jax.jit(lambda ds, state, params: jframe.frame_core(ds, state, params, CFG)[::5])


def _planes(seed, h, w):
    """World positions on a tilted plane with seeded ripples, an affine uv
    chart with seeded noise, and random unit normals."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    wpos = xx[..., None] * a[0] * 0.01 + yy[..., None] * a[1] * 0.01 + a[2] * 5.0
    wpos = (wpos + rng.normal(scale=1e-3, size=wpos.shape)).astype(np.float32)
    uv = np.stack([xx * 0.013 + yy * 0.002, yy * 0.011 - xx * 0.003], axis=-1)
    uv = (uv + rng.normal(scale=1e-4, size=uv.shape)).astype(np.float32)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    return wpos, uv, (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed,h,w", [(0, 8, 128), (1, 37, 23), (2, 64, 64)])
def test_screen_space_tbn_matches_reference(seed, h, w):
    wpos, uv, nrm = _planes(seed, h, w)
    jt, jb = (np.asarray(a) for a in jshade._screen_space_tbn(jnp.asarray(wpos), jnp.asarray(uv), jnp.asarray(nrm)))
    tt, tb = (a.numpy() for a in shade._screen_space_tbn(torch.from_numpy(wpos), torch.from_numpy(uv),
                                                          torch.from_numpy(nrm)))
    assert np.isfinite(tt).all() and np.isfinite(tb).all()
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-6)
    # the edge rows and columns repeat the last difference, and ddy is the
    # upward difference: on an exact plane the frame is the same everywhere
    assert np.abs(jt).max() > 0.1


def test_screen_space_tbn_orientation():
    """On a plane facing +z whose uv runs u -> +x and v -> up the screen
    (image rows run down), the tangent is +x and the bitangent +y."""
    h, w = 8, 16
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    wpos = np.stack([xx, -yy, np.zeros_like(xx)], axis=-1)
    uv = np.stack([xx * 0.1, -yy * 0.1], axis=-1).astype(np.float32)
    nrm = np.broadcast_to(np.float32([0, 0, 1]), (h, w, 3)).copy()
    t, b = (a.numpy() for a in shade._screen_space_tbn(*(torch.from_numpy(a) for a in (wpos, uv, nrm))))
    np.testing.assert_allclose(t, np.broadcast_to([1, 0, 0], t.shape), atol=2e-6)
    np.testing.assert_allclose(b, np.broadcast_to([0, 1, 0], b.shape), atol=2e-6)


def _mips(img):
    mips = [img]
    while img.shape[0] > 1:
        img = img[::2, ::2]
        mips.append(img)
    return mips


def _constant_map():
    """The reference test's constant tilted map: n = (0.4, ~0, 0.92)."""
    nm = np.zeros((16, 16, 4), np.uint8)
    nm[..., 0] = int(round((0.4 * 0.5 + 0.5) * 255))
    nm[..., 1] = 127
    nm[..., 2] = int(round((0.92 * 0.5 + 0.5) * 255))
    nm[..., 3] = 255
    return _mips(nm)


@pytest.fixture(scope="module", params=["constant", "sines"])
def quad_frame(request, tmp_path_factory):
    """The quad 4 units ahead with a normal-mapped material (the constant
    map, or cooker.synthesize_normal_map's sines), the reference's
    frame_core outputs and the scene and table of both packages."""
    p = tmp_path_factory.mktemp("texn") / "quad.obj"
    p.write_text(QUAD)
    g = cook_obj_meshes([str(p)], build_lods=False)
    draws = synthesize_draws(g.meshes.count, draw_count=1)
    draws.position[:] = np.array([[0.0, 0.0, -4.0]], np.float32)
    draws.scale[:] = 1.0
    draws.orientation[:] = np.array([0, 0, 0, 1], np.float32)
    draws.material_index[:] = 0
    materials = {"diffuse": np.ones((1, 4), np.float32), "specular": np.ones((1, 4), np.float32),
                 "emissive": np.zeros((1, 3), np.float32), "textures": np.array([[-1, 0, -1, -1]], np.int32)}
    mips = _constant_map() if request.param == "constant" else cooker.synthesize_normal_map(64)
    table = jtextures.build_texture_table(mips=[mips])
    ds = jscene.upload(g, draws, materials, texture_table=table)
    params, sp = jframe.make_frame_inputs(Camera(), RenderSettings(), CFG)
    state = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    jds, jtable = jax.device_put(ds), jax.device_put(table)
    fb, attrs = _core(jds, state, params)
    return dict(jds=jds, jtable=jtable, tds=scene.from_numpy(ds, "cpu"),
                ttable=textures.to_device(table, "cpu"), attrs=np.array(attrs), depth=np.array(fb.depth),
                valid=np.asarray(fb.vis) != INVALID, ivp=np.asarray(sp.inverse_view_projection))


def _gbuffers(f):
    jg0, jg1, jv = jshade.gbuffer_from_attrs(
        jnp.asarray(f["attrs"]), jnp.asarray(f["valid"]), f["jds"], textures=f["jtable"],
        depth=jnp.asarray(f["depth"]), inverse_view_projection=jnp.asarray(f["ivp"]))
    tg0, tg1, tv = shade.gbuffer_from_attrs(
        torch.from_numpy(f["attrs"]), torch.from_numpy(f["valid"]), f["tds"], textures=f["ttable"],
        depth=torch.from_numpy(f["depth"]), inverse_view_projection=f["ivp"])
    return (np.asarray(jg0), np.asarray(jg1), np.asarray(jv)), (tg0.numpy(), tg1.numpy(), tv.numpy())


def test_normal_mapped_gbuffer_matches_reference(quad_frame):
    (jg0, jg1, jv), (tg0, tg1, tv) = _gbuffers(quad_frame)
    assert quad_frame["valid"].sum() > 1000
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tg0, jg0)
    np.testing.assert_allclose(tg1, jg1, rtol=0, atol=1e-6)
    # the map bends the normal: without depth the port ignores it, as the
    # reference does, and the normals differ
    _, ug1, _ = shade.gbuffer_from_attrs(torch.from_numpy(quad_frame["attrs"]), torch.from_numpy(quad_frame["valid"]),
                                         quad_frame["tds"], textures=quad_frame["ttable"])
    assert np.abs(ug1.numpy() - tg1)[quad_frame["valid"]].max() > 0.05


@pytest.mark.parametrize("quad_frame", ["constant"], indirect=True)
def test_screen_space_tbn_analytic_frame(quad_frame):
    """The port's frame recovers the flat quad's analytic tangent: the
    constant map's tangent-space normal (0.4, ~0, 0.92) comes out as the
    same vector in world space (test_textured_fast.py:209)."""
    _, (_, tg1, _) = _gbuffers(quad_frame)
    valid = quad_frame["valid"]
    n = cullmath.oct_decode(torch.from_numpy(tg1)[..., :2] * 2 - 1).numpy()
    interior = valid.copy()
    for sh in (1, -1):
        interior &= np.roll(valid, sh, axis=0) & np.roll(valid, sh, axis=1)
    expect = np.array([0.4, 127.0 / 255.0 * 2.0 - 1.0, 0.92], np.float32)
    dots = n[interior] @ (expect / np.linalg.norm(expect))
    assert dots.size > 500
    assert np.quantile(dots, 0.05) > 0.995
