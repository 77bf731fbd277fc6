"""One frame of an instanced scene with a transmission class and normal
maps, rendered by the reference.

As frame.py renders it, with three differences, each as the renderer
defines it:

- The transmission class (post pass 2) is not drawn into the opaque
  z-buffer, which holds classes 0 and 1.  Its draws go through a z-buffer
  of their own, the layer: double-sided like every post class, with no
  alpha test in the raster.  The layer is in front where it covers a pixel
  nearer than the opaque surface, or where the opaque buffer is empty.
- A material with a normal map (texture slot 1) bends its normal through a
  tangent frame: the gradients of u and of v over the triangle's plane,
  from its world corners and uvs with the interpolated normal N, both
  scaled by the larger one's inverse length; the map's texel n (n * 2 - 1
  of the stored value, sampled as the albedo is) gives n.x T + n.y B +
  n.z N, normalized.  Positions and uvs are both linear over a triangle,
  so this is the frame that screen-space derivatives of both estimate.
- Shading is linear until the tone curve: where the layer is in front and
  survives the shade-time alpha test, the layer's colour (lit unshadowed)
  and the opaque colour (black where the opaque buffer is empty or its
  pixel is dropped by the alpha test) are averaged, then tone-mapped.

The sun rays test classes 0 and 1 only: the transmission class casts no
shadow.  The frame's `extra` holds what kinds/glass_field.py compares: per
pixel both buffers' view distance and draw, per sample the colour, the
shading and the interpolated normal, whether the material is
normal-mapped and whether the surface faces the eye, and per draw whether
the layer shows any of it.
"""

from __future__ import annotations

import dataclasses

import torch

from . import lods, raster, rays, shade
from .frame import LOD_PIXELS, SHADOW_LIFT, SHADOW_LIFT_PX, Camera, Frame, _to_view

__all__ = ["Camera", "GlassFrame", "render"]

FACING = 0.25  # N.V over which a sample faces the eye


@dataclasses.dataclass
class GlassFrame(Frame):
    extra: dict = dataclasses.field(default_factory=dict)


class _Pass:
    """The triangles of the draws `sel` at their levels, through one
    z-buffer: back faces of class 0 culled, cut at the near plane,
    projected; class 1 alpha-tested where `alpha_test`."""

    def __init__(self, sc, sel, level, position, scale, rot, cam_pos, cam_rot, cam, p00, p11, width, height, dtype,
                 alpha_test: bool):
        dev = position.device
        self.sc, self.dev = sc, dev
        views, tri_draw, tri_vert = [], [], []
        for li, lv in enumerate(sc.levels):
            d = torch.nonzero(sel & (level == li)).squeeze(1)
            if len(d) == 0:
                continue
            verts = torch.as_tensor(lv.positions, device=dev)
            faces = torch.as_tensor(lv.faces, device=dev)
            world = position[d, None, :] + scale[d, None, None] * torch.einsum("dij,nj->dni", rot[d], verts.to(dtype))
            view = _to_view(world, cam_pos, cam_rot)[:, faces].reshape(-1, 3, 3).float()
            td = d.repeat_interleave(len(faces))
            shown = raster.front_facing(view) | (sc.post_pass[td] > 0)
            views.append(view[shown])
            tri_draw.append(td[shown])
            tri_vert.append((faces.expand(len(d), -1, -1).reshape(-1, 3) + li * (1 << 40))[shown])
        if not views:
            views, tri_draw = [torch.zeros((0, 3, 3), device=dev)], [torch.zeros(0, dtype=torch.int64, device=dev)]
            tri_vert = [torch.zeros((0, 3), dtype=torch.int64, device=dev)]
        view, src, self.n_whole, self.cut_weights = raster.clip_near(torch.cat(views), cam.znear)
        self.tx, self.ty, self.tw = (a.float() for a in raster.project(view.to(dtype), p00, p11, width, height))
        self.tri_draw, tri_vert = torch.cat(tri_draw)[src], torch.cat(tri_vert)[src]
        self.tri_level = tri_vert[:, 0] >> 40
        self.tri_vert = tri_vert & ((1 << 40) - 1)
        self.uvs = [torch.as_tensor(lv.uvs, device=dev) for lv in sc.levels]
        keep = self.keep if alpha_test else None
        zbuf = raster.zbuffer(self.tx, self.ty, self.tw, width, height, cam.znear, keep=keep)
        self.tri, self.w = raster.decode(zbuf)
        self.draw = torch.where(self.tri >= 0, self.tri_draw[torch.clamp_min(self.tri, 0)], -1)
        self.draw_pixels = torch.bincount(self.draw[self.draw >= 0], minlength=len(sc.position))

    def corners(self, tri, tables):
        """Rows [K, 3, C] of per-level vertex tables [n, C] at the corners of
        triangles `tri`; a cut triangle's corners mix its source's."""
        out = torch.zeros((len(tri), 3, tables[0].shape[1]), device=self.dev)
        for li in torch.unique(self.tri_level[tri]).tolist():
            sel = torch.nonzero(self.tri_level[tri] == li).squeeze(1)
            out[sel] = tables[li][self.tri_vert[tri[sel]]]
        cut = torch.nonzero(tri >= self.n_whole).squeeze(1)
        if len(cut):
            out[cut] = self.cut_weights[tri[cut] - self.n_whole] @ out[cut]
        return out

    def uv_mip(self, tri, b, inv_w):
        """Perspective-correct uvs [K, 2] of triangles `tri` and their
        uv-to-pixel area ratios [K] (the mip's footprint)."""
        uv3 = self.corners(tri, self.uvs)
        w3 = self.tw[tri]
        wt = torch.stack([b[0] / w3[:, 0], b[1] / w3[:, 1], b[2] / w3[:, 2]], -1) / inv_w[:, None]
        uv = (wt[..., None] * uv3).sum(1)
        uv_area = torch.abs((uv3[:, 1, 0] - uv3[:, 0, 0]) * (uv3[:, 2, 1] - uv3[:, 0, 1])
                            - (uv3[:, 2, 0] - uv3[:, 0, 0]) * (uv3[:, 1, 1] - uv3[:, 0, 1]))
        t3x, t3y = self.tx[tri], self.ty[tri]
        px_area = torch.abs((t3x[:, 1] - t3x[:, 0]) * (t3y[:, 2] - t3y[:, 0])
                            - (t3x[:, 2] - t3x[:, 0]) * (t3y[:, 1] - t3y[:, 0]))
        return uv, uv_area / torch.clamp_min(px_area, 1e-6)

    def texel(self, tri, uv, ratio, table, full_res=False):
        """Samples [K, 4] of the textures that `table` (a texture index a
        material, -1: none) gives the materials of triangles `tri`, at the
        footprint's mip or at mip 0; 1 where a material has none."""
        out = torch.ones((len(tri), 4), device=self.dev)
        mat = self.sc.material[self.tri_draw[tri]]
        for m in torch.unique(mat).tolist():
            ti = table[m]
            if ti < 0:
                continue
            sel = torch.nonzero(mat == m).squeeze(1)
            chain = self.sc.textures[ti]
            h, w_ = chain[0].shape[:2]
            mip = shade.mip_level(ratio[sel], h * w_, len(chain))
            out[sel] = shade.sample(chain, uv[sel], torch.zeros_like(mip) if full_res else mip)
        return out

    def keep(self, tri, b, inv_w):
        """The raster's alpha test: post-class fragments survive where the
        albedo's full-resolution alpha is at least 0.5."""
        ok = torch.ones(len(tri), dtype=torch.bool, device=self.dev)
        a = torch.nonzero(self.sc.post_pass[self.tri_draw[tri]] > 0).squeeze(1)
        if len(a):
            uv, ratio = self.uv_mip(tri[a], tuple(x[a] for x in b), inv_w[a])
            ok[a] = self.texel(tri[a], uv, ratio, self.sc.material_texture, full_res=True)[:, 3] >= 0.5
        return ok


def _radiance(albedo, normal, point, camera, sun, gloss, shadow):
    """shade.lit before its tone curve: linear colour [K, 3]."""
    ndotl = torch.clamp_min(normal @ sun, 0.0)
    view = camera[None, :] - point
    view = view / torch.clamp_min(view.norm(dim=-1, keepdim=True), 1e-20)
    half = view + sun[None, :]
    half = half / torch.clamp_min(half.norm(dim=-1, keepdim=True), 1e-20)
    ndoth = torch.clamp_min((normal * half).sum(-1), 1e-6)
    spec = ndoth ** (1.0 + 63.0 * gloss) * gloss * shadow
    light = ndotl * torch.clamp_max(shadow + shade.SKY_FILL, 1.0) * shade.SUN_INTENSITY + shade.AMBIENT
    return albedo * light[:, None] + (spec * shade.SUN_INTENSITY)[:, None]


def _unit(v):
    return v / torch.clamp_min(v.norm(dim=-1, keepdim=True), 1e-20)


def render(sc, cam: Camera, width: int, height: int, draw_distance: float, sun, samples, *, normal_texture: list,
           shadows: bool, dtype=torch.float32) -> GlassFrame:
    """The frame.  `samples` [S] are pixel indices (y * width + x) to shade;
    `normal_texture` a texture index a material (its normal map, -1: none);
    `dtype` the precision of the vertex stage up to screen coordinates and
    view distance, the tangent frame, the sun rays and the lighting (the
    z-buffers compare float32 copies)."""
    dev = sc.position.device
    p00, p11 = shade.focal(cam.fov_y, width, height)
    cam_pos = cam.position.to(dtype)
    cam_rot = shade.quat_matrix(cam.orientation[None].to(dtype))[0]
    rot = shade.quat_matrix(sc.orientation.to(dtype))
    position, scale = sc.position.to(dtype), sc.scale.to(dtype)

    # draws in range, and each one's level (frame.py's rule)
    c = _to_view(position, cam_pos, cam_rot).float()
    r = sc.radius * sc.scale
    side = lambda f: (torch.abs(c[:, f]) - c[:, 2] / (p00 if f == 0 else p11)) \
        / (1.0 + 1.0 / (p00 if f == 0 else p11) ** 2) ** 0.5  # noqa: E731
    inside = (c[:, 2] + r > cam.znear) & (c[:, 2] - r < draw_distance) & (side(0) < r) & (side(1) < r)
    pix = 2.0 / (p11 * height)
    dist = torch.clamp_min(c.norm(dim=1) - r, 0.0)
    level = lods.pick_level([lv.error for lv in sc.levels], LOD_PIXELS * pix * dist / sc.scale)

    glass = sc.post_pass == 2
    args = (level, position, scale, rot, cam_pos, cam_rot, cam, p00, p11, width, height, dtype)
    main = _Pass(sc, inside & ~glass, *args, alpha_test=True)
    layer = _Pass(sc, inside & glass, *args, alpha_test=False)

    sunv = torch.as_tensor(sun, dtype=torch.float32, device=dev).to(dtype)
    normals = [torch.as_tensor(lv.normals, device=dev) for lv in sc.levels]
    positions = [torch.as_tensor(lv.positions, device=dev) for lv in sc.levels]

    def surface(ps, cov):
        """At the samples `cov` that pass `ps` covers: (draw, the
        interpolated unit normal N, the world point, the shading normal,
        the albedo texel, whether the material is normal-mapped)."""
        t = ps.tri[samples[cov]]
        sx = (samples[cov] % width).float() + 0.5
        sy = (samples[cov] // width).float() + 0.5
        b = raster.barycentric(sx, sy, ps.tx[t], ps.ty[t])[:3]
        w3 = ps.tw[t]
        inv_w = b[0] / w3[:, 0] + b[1] / w3[:, 1] + b[2] / w3[:, 2]
        wt = torch.stack([b[0] / w3[:, 0], b[1] / w3[:, 1], b[2] / w3[:, 2]], -1) / inv_w[:, None]
        d = ps.tri_draw[t]
        rd = rot[d]
        nrm = _unit((rd @ (wt[:, :, None] * ps.corners(t, normals)).sum(1).to(dtype)[..., None])[..., 0])
        corner = ps.corners(t, positions).to(dtype)
        world = position[d, None, :] + scale[d, None, None] * torch.einsum("kij,knj->kni", rd, corner)
        point = (wt.to(dtype)[:, :, None] * world).sum(1)
        uv, ratio = ps.uv_mip(t, b, inv_w)
        tex = ps.texel(t, uv, ratio, sc.material_texture)
        mapped = torch.as_tensor(normal_texture, device=dev)[sc.material[d]] >= 0
        shading = nrm
        if bool(mapped.any()):
            # the tangent frame: grad u and grad v over the triangle's plane,
            # du(a) (b x N) + du(b) (N x a) over N . (a x b) for its edges a, b
            e1, e2 = world[:, 1] - world[:, 0], world[:, 2] - world[:, 0]
            uv3 = ps.corners(t, ps.uvs).to(dtype)
            duv1, duv2 = uv3[:, 1] - uv3[:, 0], uv3[:, 2] - uv3[:, 0]
            a_perp, b_perp = torch.linalg.cross(e2, nrm), torch.linalg.cross(nrm, e1)
            det = (nrm * torch.linalg.cross(e1, e2)).sum(1, keepdim=True)
            det = torch.where(det.abs() < 1e-30, 1e-30, det)
            tan = (a_perp * duv1[:, 0:1] + b_perp * duv2[:, 0:1]) / det
            bit = (a_perp * duv1[:, 1:2] + b_perp * duv2[:, 1:2]) / det
            inv = torch.rsqrt(torch.clamp_min(torch.maximum((tan * tan).sum(1), (bit * bit).sum(1)), 1e-20))[:, None]
            n_tex = ps.texel(t, uv, ratio, normal_texture)[:, :3].to(dtype) * 2.0 - 1.0
            bent = _unit(n_tex[:, 0:1] * tan * inv + n_tex[:, 1:2] * bit * inv + n_tex[:, 2:3] * nrm)
            shading = torch.where(mapped[:, None], bent, nrm)
        return d, nrm, point, shading, tex, mapped

    def radiance(d, point, shading, tex, shadow):
        gloss = sc.gloss[sc.material[d]].to(dtype)
        albedo = (torch.clamp_min(tex[:, :3], 0.0) ** 2.2 * sc.diffuse[sc.material[d]]).to(dtype)
        return _radiance(albedo, shading, point, cam_pos, sunv, gloss, shadow.to(dtype)).float()

    S = len(samples)
    sun_vis, ndotl = torch.ones(S, device=dev), torch.zeros(S, device=dev)
    opaque = torch.zeros((S, 3), device=dev)  # linear; black where empty or dropped
    normal, base = torch.zeros((S, 3), device=dev), torch.zeros((S, 3), device=dev)
    mapped_s, facing = torch.zeros(S, dtype=torch.bool, device=dev), torch.zeros(S, dtype=torch.bool, device=dev)
    valid = main.tri[samples] >= 0
    cov = torch.nonzero(valid).squeeze(1)
    if len(cov):
        d, nrm, point, shading, tex, mapped = surface(main, cov)
        ndotl[cov] = torch.clamp_min(nrm @ sunv, 0.0).float()
        if shadows:
            lift = (SHADOW_LIFT + SHADOW_LIFT_PX * pix * main.w[samples[cov]]).to(dtype)
            lv = sc.levels[sc.ray_level]
            blocked = rays.blocked(point + lift[:, None] * sunv[None, :], sunv, position, rot, scale, sc.radius,
                                   torch.as_tensor(lv.positions, device=dev).to(dtype),
                                   torch.as_tensor(lv.faces, device=dev), draw_mask=~glass)
            sun_vis[cov] = torch.where(blocked, 0.0, 1.0)
        dropped = (sc.post_pass[d] > 0) & (tex[:, 3] < 0.5)
        opaque[cov] = torch.where(dropped[:, None], 0.0, radiance(d, point, shading, tex, sun_vis[cov]))
        valid[cov] = ~dropped
        normal[cov], base[cov] = shading.float(), nrm.float()
        mapped_s[cov] = mapped
        facing[cov] = (nrm * _unit(cam_pos[None, :] - point)).sum(1).float() > FACING

    # the layer, where it is in front of what the opaque buffer shows
    color = opaque.clone()
    w_main, w_layer = main.w[samples], layer.w[samples]
    lcov = torch.nonzero((layer.tri[samples] >= 0) & ((w_layer < w_main) | ~valid)).squeeze(1)
    if len(lcov):
        d, _, point, shading, tex, _ = surface(layer, lcov)
        kept = ~((sc.post_pass[d] > 0) & (tex[:, 3] < 0.5))
        glass_color = radiance(d, point, shading, tex, torch.ones(len(lcov), device=dev))
        color[lcov] = torch.where(kept[:, None], 0.5 * opaque[lcov] + 0.5 * glass_color, opaque[lcov])
    color = shade.tone(color)

    extra = dict(w=main.w, draw=main.draw, w_layer=layer.w, layer_draw=layer.draw, color=color, normal=normal,
                 base_normal=base, mapped=mapped_s, facing=facing, layer_vis=layer.draw_pixels > 0)
    return GlassFrame(w=main.w, draw=main.draw, draw_pixels=main.draw_pixels, color=color, sun=sun_vis, ndotl=ndotl,
                      samples=samples, extra=extra)
