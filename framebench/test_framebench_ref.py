"""The reference's parts on hand-made cases: the z-buffer, the ray tests,
the levels of detail and the sun map's depths.

    python -m pytest framebench -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tinyrun  # noqa: F401  (puts framebench and the repository on sys.path)
from data import torus_field
from ref import lods, raster, rays, sunmap


def test_zbuffer_nearest_fragment_at_pixel_centres():
    # a square of two triangles over pixels [2, 6) x [1, 4) at w = 2, and a
    # nearer triangle (0,0)-(3,0)-(0,3) at w = 1 covering centres x + y <= 3
    tx = torch.tensor([[2.0, 6, 6], [2, 6, 2], [0, 3, 0]])
    ty = torch.tensor([[1.0, 1, 4], [1, 4, 4], [0, 0, 3]])
    tw = torch.tensor([[2.0, 2, 2], [2, 2, 2], [1, 1, 1]])
    tri, w = raster.decode(raster.zbuffer(tx, ty, tw, 8, 5, 0.1, budget=5))
    tri = tri.reshape(5, 8)
    assert tri[0].tolist() == [2, 2, 2, -1, -1, -1, -1, -1]
    assert tri[2].tolist() == [2, -1, 1, 1, 0, 0, -1, -1]
    assert (tri[1:4, 3:6] >= 0).all() and (tri[4] == -1).all()
    assert float(w.reshape(5, 8)[3, 3]) == 2.0 and float(w.reshape(5, 8)[0, 0]) == 1.0
    # a triangle reaching behind the near plane is skipped
    tri, _ = raster.decode(raster.zbuffer(tx[:1], ty[:1], torch.tensor([[2.0, 0.05, 2]]), 8, 5, 0.1))
    assert (tri == -1).all()


@pytest.mark.parametrize("n_beyond", [1, 2])
def test_near_plane_cut(n_beyond):
    """A triangle crossing the near plane keeps the part beyond it, in its
    winding, and its corners' weights rebuild them from the source's."""
    znear = 0.5
    w = [2.0, 0.1, 0.2] if n_beyond == 1 else [2.0, 3.0, 0.1]
    tri = torch.tensor([[[-1.0, -1, w[0]], [1, -1, w[1]], [0, 1, w[2]]]])
    whole = torch.tensor([[[-1.0, -1, 2], [1, -1, 2], [0, 1, 2]]])
    behind = torch.tensor([[[-1.0, -1, 0.1], [1, -1, -0.2], [0, 1, 0.3]]])
    out, src, n_whole, weights = raster.clip_near(torch.cat([whole, tri, behind]), znear)
    assert n_whole == 1 and src.tolist() == [0] + [1] * n_beyond
    assert torch.equal(out[0], whole[0]) and (out[..., 2] >= znear).all()
    assert torch.allclose(out[1:], weights @ tri.expand(n_beyond, 3, 3), atol=1e-6)
    assert torch.allclose(weights.sum(-1), torch.ones(n_beyond, 3))
    assert (raster.front_facing(out) == raster.front_facing(tri)).all()
    # the cut corners lie on the plane, on the triangle's edges
    on_plane = torch.isclose(out[1:, :, 2], torch.tensor(znear))
    assert int(on_plane.sum()) == {1: 2, 2: 3}[n_beyond]


def test_front_facing_by_winding():
    a = torch.tensor([[[-1.0, -1, 2], [1, -1, 2], [0, 1, 2]]])  # counter-clockwise, y up
    assert raster.front_facing(a).tolist() == [True]
    assert raster.front_facing(a[:, [0, 2, 1]]).tolist() == [False]
    # with a corner behind the eye it faces as its part beyond the near plane
    b = torch.tensor([[[-1.0, -1, 2], [1, -1, 2], [0, 1, -1]]])
    for t in (b, b[:, [0, 2, 1]]):
        part = raster.clip_near(t, 0.5)[0]
        assert len(part) == 2 and (raster.front_facing(part) == raster.front_facing(t)).all()


def test_rays_any_and_nearest_hit():
    verts = torch.tensor([[-1.0, -1, 0], [1, -1, 0], [0, 1, 0]])
    faces = torch.tensor([[0, 1, 2]])
    pos = torch.tensor([[0.0, 0, 5], [0, 0, 8], [10, 0, 5]])
    rot = torch.eye(3).expand(3, 3, 3).contiguous()
    scale = torch.tensor([1.0, 1.0, 2.0])
    o = torch.tensor([[0.0, 0, 0], [0, 0, 10], [10, 0.5, 0], [10, 3, 0]])
    d = torch.tensor([0.0, 0, 1])
    assert rays.blocked(o, d, pos, rot, scale, 1.5, verts, faces).tolist() == [True, False, True, False]
    t, hit = rays.first_hit(o, d, pos, rot, scale, 1.5, verts, faces, torch.ones(3, dtype=torch.bool),
                            torch.tensor([0, -1, -1, -1]))
    assert hit.tolist() == [1, -1, 2, -1] and t[0] == 8.0 and t[2] == 5.0


def test_levels_errors_fall_with_triangles():
    pos, nrm, _ = torus_field.torus_mesh()
    uv = torus_field.planar_uvs(pos).astype(np.float32)
    levels = lods.build_levels(pos, nrm, uv, 512, 56)
    assert levels[0].error == 0.0 and len(levels[0].faces) == 512 * 56 * 2
    counts = [len(lv.faces) for lv in levels]
    errors = [lv.error for lv in levels]
    assert counts == sorted(counts, reverse=True) and errors == sorted(errors)
    # a level's vertices lie on the surface: its error is the chords' sag,
    # which for the ring alone (su = 2) is small
    assert 0 < levels[1].error < 1e-3
    pick = lods.pick_level(errors, torch.tensor([0.0, 1e-3, 1.0]))
    assert pick[0] == 0 and errors[int(pick[1])] < 1e-3 and int(pick[2]) == len(levels) - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sun_depths_of_a_plane(dtype):
    """A square of two triangles facing the light at basis depth 10, in a
    map frame whose depth runs [0, 100]: every texel over it reads
    1 - 0.998 * 0.1, the others 0."""
    verts = torch.tensor([[-5.0, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    frame = dict(rows=torch.eye(3), lo=torch.tensor([-10.0, -10, 0]), hi=torch.tensor([10.0, 10, 100]))
    rows, lo, hi = sunmap.frame_arrays(frame, torch.device("cpu"))
    texels = torch.tensor([0 * 8 + 0, 4 * 8 + 4, 3 * 8 + 2])  # a corner, the centre, inside
    z, hit = sunmap.depths(texels, rows, lo, hi, 8, 8, torch.tensor([[0.0, 0, 10]]), torch.tensor([[0.0, 0, 0, 1]]),
                           torch.tensor([1.0]), 7.5, verts, faces, dtype=dtype)
    assert hit.tolist() == [-1, 0, 0] and z[0] == 0.0
    assert torch.allclose(z[1:], torch.full((2,), 1 - 0.998 * 0.1), atol=1e-6 if dtype == torch.float32 else 1e-2)
