"""One frame of an instanced scene, rendered by the reference.

Every draw whose bounding sphere lies in front of the near plane, inside
the draw distance (its nearest point along the view axis closer than it)
and not wholly outside the view's side planes is drawn at the cheapest
level of detail whose error, scaled by the draw, stays under one pixel at
the sphere's nearest distance (the full mesh where none does); its
triangles go through the z-buffer (raster.py), cut at the near plane, the
opaque class's back faces culled.  Alpha-class draws (post pass > 0) are
double-sided and tested twice, as the renderer defines them: in the raster
a fragment survives where the texture's full-resolution alpha is at least
0.5, and in shading a pixel whose alpha at its shading mip is under 0.5
is dropped (black; it keeps its depth).  Nothing is culled by occlusion.

At a sample of pixels the reference also shades the visible point
(shade.py) with the sun's visibility from rays.py: a ray from the point
(lifted off the surface by a few pixels' worth, which covers the level's
error) towards the sun, against every draw at a fine level, opaque.
"""

from __future__ import annotations

import dataclasses

import torch

from . import lods, raster, rays, shade

LOD_PIXELS = 1.0
SHADOW_LIFT_PX = 2.0
SHADOW_LIFT = 0.01


@dataclasses.dataclass
class Scene:
    """A scene as the reference holds it, on one device."""

    levels: list  # lods.Level, finest first
    radius: float  # the mesh's bounding sphere about its origin
    position: torch.Tensor  # f32 [D, 3]
    scale: torch.Tensor  # f32 [D]
    orientation: torch.Tensor  # f32 [D, 4] (x, y, z, w)
    material: torch.Tensor  # i64 [D]
    post_pass: torch.Tensor  # i64 [D]
    textures: list  # per texture, its mip chain: f32 [h, w, 4] in [0, 1]
    material_texture: list  # per material, a texture index or -1
    diffuse: torch.Tensor  # f32 [M, 3] linear factors of the albedo
    gloss: torch.Tensor  # f32 [M]
    ray_level: int  # the level the sun rays test

    @classmethod
    def build(cls, mesh_levels, draws: dict, materials: dict, mips: list, dev, ray_error: float = 0.03):
        if (materials["emissive"] != 0).any():
            raise ValueError("the reference lights no emissive materials")
        radius = float(max(float((lv.positions.astype("float64") ** 2).sum(1).max()) for lv in mesh_levels) ** 0.5)
        errors = [lv.error for lv in mesh_levels]
        ray_level = max(i for i, e in enumerate(errors) if e <= ray_error)
        t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731  (copies)
        chains = [[t(m).float() / 255.0 for m in chain] for chain in mips]
        return cls(levels=mesh_levels, radius=radius, position=t(draws["position"]), scale=t(draws["scale"]),
                   orientation=t(draws["orientation"]), material=t(draws["material_index"], torch.int64),
                   post_pass=t(draws["post_pass"], torch.int64), textures=chains,
                   material_texture=[int(v) for v in materials["textures"][:, 0]],
                   diffuse=t(materials["diffuse"][:, :3]), gloss=t(materials["specular"][:, 3]),
                   ray_level=ray_level)


@dataclasses.dataclass
class Camera:
    position: torch.Tensor  # f32 [3]
    orientation: torch.Tensor  # f32 [4] (x, y, z, w): camera to world; the view looks down its -z
    fov_y: float
    znear: float


@dataclasses.dataclass
class Frame:
    w: torch.Tensor  # f32 [H * W] view distance, inf where uncovered
    draw: torch.Tensor  # i64 [H * W] draw id, -1 where uncovered
    draw_pixels: torch.Tensor  # i64 [D] pixels each draw covers
    color: torch.Tensor  # f32 [S, 3] the sampled pixels' colour
    sun: torch.Tensor  # f32 [S] sun visibility, 1 or 0 (1 where uncovered or unshadowed)
    ndotl: torch.Tensor  # f32 [S]
    samples: torch.Tensor  # i64 [S] the sampled pixels


def _to_view(points, cam_pos, cam_rot):
    v = (points - cam_pos) @ cam_rot  # R^T (p - c) as rows
    return torch.stack([v[..., 0], v[..., 1], -v[..., 2]], -1)


def render(sc: Scene, cam: Camera, width: int, height: int, draw_distance: float, sun, samples, *,
           shadows: bool, dtype=torch.float32) -> Frame:
    """The frame.  `samples` [S] are pixel indices (y * width + x) to shade.
    `dtype` is the precision of the arithmetic (the control's bfloat16):
    the vertex stage up to screen coordinates and view distance, the sun
    rays and the lighting; the z-buffer compares float32 copies."""
    dev = sc.position.device
    p00, p11 = shade.focal(cam.fov_y, width, height)
    cam_pos = cam.position.to(dtype)
    cam_rot = shade.quat_matrix(cam.orientation[None].to(dtype))[0]
    rot = shade.quat_matrix(sc.orientation.to(dtype))
    position, scale = sc.position.to(dtype), sc.scale.to(dtype)

    # draws in range, and each one's level
    c = _to_view(position, cam_pos, cam_rot).float()
    r = sc.radius * sc.scale
    side = lambda f: (torch.abs(c[:, f]) - c[:, 2] / (p00 if f == 0 else p11)) \
        / (1.0 + 1.0 / (p00 if f == 0 else p11) ** 2) ** 0.5  # noqa: E731
    inside = (c[:, 2] + r > cam.znear) & (c[:, 2] - r < draw_distance) & (side(0) < r) & (side(1) < r)
    pix = 2.0 / (p11 * height)  # a pixel's size at distance 1
    dist = torch.clamp_min(c.norm(dim=1) - r, 0.0)
    level = lods.pick_level([lv.error for lv in sc.levels], LOD_PIXELS * pix * dist / sc.scale)

    # every drawn triangle, level by level: the opaque class's back faces
    # culled (the post classes are double-sided), then cut at the near plane
    views, tri_draw, tri_vert = [], [], []
    for li, lv in enumerate(sc.levels):
        d = torch.nonzero(inside & (level == li)).squeeze(1)
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
        tri_vert.append((faces.expand(len(d), -1, -1).reshape(-1, 3) + li * (1 << 40))[shown])  # the level in bit 40
    view, src, n_whole, cut_weights = raster.clip_near(torch.cat(views), cam.znear)
    tx, ty, tw = (a.float() for a in raster.project(view.to(dtype), p00, p11, width, height))
    tri_draw, tri_vert = torch.cat(tri_draw)[src], torch.cat(tri_vert)[src]
    tri_level = tri_vert[:, 0] >> 40
    tri_vert = tri_vert & ((1 << 40) - 1)
    uvs = [torch.as_tensor(lv.uvs, device=dev) for lv in sc.levels]

    def corners(tri, tables):
        """Rows [K, 3, C] of per-level vertex tables [n, C] at the corners of
        triangles `tri`; a cut triangle's corners mix its source's."""
        out = torch.zeros((len(tri), 3, tables[0].shape[1]), device=dev)
        for li in torch.unique(tri_level[tri]).tolist():
            sel = torch.nonzero(tri_level[tri] == li).squeeze(1)
            out[sel] = tables[li][tri_vert[tri[sel]]]
        cut = torch.nonzero(tri >= n_whole).squeeze(1)
        if len(cut):
            out[cut] = cut_weights[tri[cut] - n_whole] @ out[cut]
        return out

    def texel(tri, b, inv_w, full_res=False):
        """Texture samples [K, 4] of the materials of triangles `tri` at
        perspective-correct barycentrics, at the footprint's mip or at mip 0
        (1, where a material has none)."""
        uv3 = corners(tri, uvs)
        w3 = tw[tri]
        wt = torch.stack([b[0] / w3[:, 0], b[1] / w3[:, 1], b[2] / w3[:, 2]], -1) / inv_w[:, None]
        uv = (wt[..., None] * uv3).sum(1)
        uv_area = torch.abs((uv3[:, 1, 0] - uv3[:, 0, 0]) * (uv3[:, 2, 1] - uv3[:, 0, 1])
                            - (uv3[:, 2, 0] - uv3[:, 0, 0]) * (uv3[:, 1, 1] - uv3[:, 0, 1]))
        t3x, t3y = tx[tri], ty[tri]
        px_area = torch.abs((t3x[:, 1] - t3x[:, 0]) * (t3y[:, 2] - t3y[:, 0])
                            - (t3x[:, 2] - t3x[:, 0]) * (t3y[:, 1] - t3y[:, 0]))
        ratio = uv_area / torch.clamp_min(px_area, 1e-6)
        out = torch.ones((len(tri), 4), device=dev)
        mat = sc.material[tri_draw[tri]]
        for m in torch.unique(mat).tolist():
            ti = sc.material_texture[m]
            if ti < 0:
                continue
            sel = torch.nonzero(mat == m).squeeze(1)
            chain = sc.textures[ti]
            h, w_ = chain[0].shape[:2]
            mip = shade.mip_level(ratio[sel], h * w_, len(chain))
            out[sel] = shade.sample(chain, uv[sel], torch.zeros_like(mip) if full_res else mip)
        return out

    alpha_tri = sc.post_pass[tri_draw] > 0

    def keep(tri, b, inv_w):
        ok = torch.ones(len(tri), dtype=torch.bool, device=dev)
        a = torch.nonzero(alpha_tri[tri]).squeeze(1)
        if len(a):
            ok[a] = texel(tri[a], tuple(x[a] for x in b), inv_w[a], full_res=True)[:, 3] >= 0.5
        return ok

    zbuf = raster.zbuffer(tx, ty, tw, width, height, cam.znear, keep=keep)
    tri, w = raster.decode(zbuf)
    draw = torch.where(tri >= 0, tri_draw[torch.clamp_min(tri, 0)], -1)
    draw_pixels = torch.bincount(draw[draw >= 0], minlength=len(sc.position))

    # the samples: shading and the sun's visibility
    S = len(samples)
    st = tri[samples]
    cov = torch.nonzero(st >= 0).squeeze(1)
    color = torch.zeros((S, 3), device=dev)
    sun_vis = torch.ones(S, device=dev)
    ndotl = torch.zeros(S, device=dev)
    if len(cov):
        t = st[cov]
        sx = (samples[cov] % width).float() + 0.5
        sy = (samples[cov] // width).float() + 0.5
        b = raster.barycentric(sx, sy, tx[t], ty[t])[:3]
        w3 = tw[t]
        inv_w = b[0] / w3[:, 0] + b[1] / w3[:, 1] + b[2] / w3[:, 2]
        wt = torch.stack([b[0] / w3[:, 0], b[1] / w3[:, 1], b[2] / w3[:, 2]], -1) / inv_w[:, None]
        d = tri_draw[t]
        nrm = (wt[:, :, None] * corners(t, [torch.as_tensor(lv.normals, device=dev) for lv in sc.levels])).sum(1)
        loc = (wt[:, :, None] * corners(t, [torch.as_tensor(lv.positions, device=dev) for lv in sc.levels])).sum(1)
        nrm = (rot[d] @ nrm.to(dtype)[..., None])[..., 0]
        nrm = nrm / torch.clamp_min(nrm.norm(dim=1, keepdim=True), 1e-20)
        point = position[d] + scale[d, None] * (rot[d] @ loc.to(dtype)[..., None])[..., 0]
        tex = texel(t, b, inv_w)
        sunv = torch.as_tensor(sun, dtype=torch.float32, device=dev).to(dtype)
        ndotl[cov] = torch.clamp_min(nrm @ sunv, 0.0).float()
        if shadows:
            lift = (SHADOW_LIFT + SHADOW_LIFT_PX * pix * (1.0 / inv_w)).to(dtype)
            origin = point + lift[:, None] * sunv[None, :]
            lv = sc.levels[sc.ray_level]
            rv = torch.as_tensor(lv.positions, device=dev).to(dtype)
            rf = torch.as_tensor(lv.faces, device=dev)
            blocked = rays.blocked(origin, sunv, position, rot, scale, sc.radius, rv, rf)
            sun_vis[cov] = torch.where(blocked, 0.0, 1.0)
        gloss = sc.gloss[sc.material[d]]
        albedo = (torch.clamp_min(tex[:, :3], 0.0) ** 2.2 * sc.diffuse[sc.material[d]]).to(dtype)
        dropped = (sc.post_pass[d] > 0) & (tex[:, 3] < 0.5)
        lit = shade.lit(albedo, nrm, point, cam_pos, sunv, gloss.to(dtype), sun_vis[cov].to(dtype)).float()
        color[cov] = torch.where(dropped[:, None], 0.0, lit)
    return Frame(w=w, draw=draw, draw_pixels=draw_pixels, color=color, sun=sun_vis, ndotl=ndotl, samples=samples)
