"""G-buffer encode, composite and debug views (niagara_tpu/ops/shade.py):
`gbuffer_from_attrs` (:260) with its material fetch (`_mat_rows` :159,
here one gather), texture sampling (`_sample_materials` :173, all four
slots), normal maps through the screen-space tangent frame
(`_screen_space_tbn` :224, :297-325) and the shade-time alpha discard
(:319); `_lit_color` (:378) and `composite` (:420) with the sun-map
shadow term (:415-416, 444), the bloom term (:451-452) and the
transmission layer's depth-tested blend (:460-475); `debug_visualize`
and `_hash_color` (:482-516); `pack_gbuffer` / `unpack_gbuffer` (:340-375),
the sharded frame's G-buffer encoding (parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..render import textures as tex_mod
from . import cullmath
from .raster import INVALID_FRAG

_LUM = (0.3, 0.6, 0.1)


def _sample_materials(scene, textures, row, uv, duv):
    """Material factors of the per-pixel megarows `row` times their
    sampled textures (shade.py:173).  Returns (albedo, specgloss,
    emissive, tangent-space normal [..., 3] or None when no material has a
    normal map, texture ids)."""
    albedo, specgloss, emissive = row[..., 0:4], row[..., 4:8], row[..., 8:11]
    tex_ids = row[..., 11:15].to(torch.int32)
    mip = tex_mod.select_mip_from_area(duv, torch.clamp_min(row[..., 15], 1.0))
    meta0 = None
    if scene.has_texture_meta and textures.texels.shape[0] < (1 << 24):
        meta0 = tuple(row[..., 16 + i].to(torch.int32) for i in range(4))

    def tex(idx, meta=None):
        return tex_mod.sample(textures, tex_ids[..., idx], uv, mip, meta=meta)

    slots = scene.texture_slots
    if slots[0]:
        t = tex(0, meta=meta0)
        albedo = albedo * torch.where((tex_ids[..., 0] > 0)[..., None],
                                      torch.cat([cullmath.from_srgb(t[..., :3]), t[..., 3:]], dim=-1), 1.0)
    nmap = tex(1)[..., :3] * 2.0 - 1.0 if slots[1] else None
    if slots[2]:
        specgloss = specgloss * torch.where((tex_ids[..., 2] > 0)[..., None], cullmath.from_srgb(tex(2)), 1.0)
    if slots[3]:
        emissive = emissive * torch.where((tex_ids[..., 3] > 0)[..., None], cullmath.from_srgb(tex(3)[..., :3]), 1.0)
    return albedo, specgloss, emissive, nmap, tex_ids


def _screen_space_tbn(wpos, uv, nrm):
    """Tangent and bitangent [H, W, 3] from screen-space differences of
    world position and uv (shade.py:224): `ddx` the difference to the next
    column, `ddy` the upward one (the row above minus this row: the frame
    wants a y-up screen), each repeating its last difference at the
    edge.  The reference's rsqrt is one IEEE square root and one IEEE
    division here, on every device."""

    def ddx(a):
        d = a[:, 1:] - a[:, :-1]
        return torch.cat([d, d[:, -1:]], dim=1)

    def ddy(a):
        d = a[:-1] - a[1:]
        return torch.cat([d, d[-1:]], dim=0)

    dp1, dp2 = ddx(wpos), ddy(wpos)
    du1, dv1 = ddx(uv[..., 0]), ddx(uv[..., 1])
    du2, dv2 = ddy(uv[..., 0]), ddy(uv[..., 1])
    dp2perp = cullmath.cross(dp2, nrm)
    dp1perp = cullmath.cross(nrm, dp1)
    t = dp2perp * du1[..., None] + dp1perp * du2[..., None]
    b = dp2perp * dv1[..., None] + dp1perp * dv2[..., None]
    inv = cullmath.rdiv(1.0, torch.sqrt(torch.clamp_min(torch.maximum(cullmath.dot3(t, t), cullmath.dot3(b, b)),
                                                        1e-20)))[..., None]
    return t * inv, b * inv


def _world_position(depth, inverse_view_projection, width: int, height: int):
    """World position [H, W, 3] of every pixel centre from reverse-Z depth
    (shade.py:309-322, 388-398): the NDC planes through the inverse
    view-projection (host constants), divided by w guarded at 1e-20."""
    ndc_x, ndc_y = ndc_planes(width, height, depth.device)
    ivp = inverse_view_projection
    clip = (ndc_x[None, :].expand(depth.shape), ndc_y[:, None].expand(depth.shape), depth)
    wposh = [clip[0] * float(ivp[i, 0]) + clip[1] * float(ivp[i, 1]) + clip[2] * float(ivp[i, 2])
             + float(ivp[i, 3]) for i in range(4)]
    wdiv = torch.where(torch.abs(wposh[3]) < 1e-20, 1e-20, wposh[3])
    return torch.stack(wposh[:3], dim=-1) / wdiv[..., None]


def gbuffer_from_attrs(attrs_img, valid, scene, textures=None, *, depth=None, inverse_view_projection=None,
                       stages=None, counter: str = "G-buffer pixels"):
    """Dense G-buffer from the shade kernel's attribute planes [H,W,13]:
    g0 = srgb albedo + log emissive, g1 = oct normal + gloss.  With
    `textures` (render.textures.TextureTable on the device) it samples the
    materials' textures and discards post-pass pixels whose albedo alpha
    is under 0.5; a material with a normal map bends the normal through
    the screen-space tangent frame, which needs `depth` [H, W] and
    `inverse_view_projection` (without them the map is ignored, as in the
    reference).  CPU tensors take the plain twin (gbuffer_plain), CUDA
    tensors the kernel (gbuffer_cuda).  `stages` (a StageTimer) gets the
    count `counter`: the pixels shaded (the returned valid mask's) against
    the frame's pixels; both routes count whether or not it is given.
    Returns (g0, g1, valid)."""
    kw = dict(depth=depth, inverse_view_projection=inverse_view_projection)
    if attrs_img.device.type == "cpu":
        g0, g1, valid = gbuffer_plain(attrs_img, valid, scene, textures, **kw)
        shaded = valid.sum()
    else:
        g0, g1, valid, shaded = gbuffer_cuda(attrs_img, valid, scene, textures, **kw)
    if stages is not None:
        stages.count(counter, shaded, valid.numel())
    return g0, g1, valid


def gbuffer_cuda(attrs_img, valid, scene, textures=None, *, depth=None, inverse_view_projection=None):
    """The G-buffer kernel (csrc/gbuffer.cu): gbuffer_plain's contract in
    one launch, plus the pixels it shaded (an int64 [1] word the kernel
    sums into).  It allocates only its outputs.  Returns (g0, g1, valid,
    shaded)."""
    _build.require_cuda(attrs_img, "gbuffer")
    H, W = valid.shape
    _build.expect(attrs_img, torch.float32, (H, W, 13), "gbuffer attrs")
    _build.expect(valid, torch.bool, (H, W), "gbuffer valid")
    nm, row_len = scene.mat_row.shape
    _build.expect(scene.mat_row, torch.float32, (nm, row_len), "gbuffer mat_row")
    if row_len < 20:
        raise ValueError(f"gbuffer: material rows of {row_len} columns, expected 20")
    dev = attrs_img.device
    keep = [attrs_img.contiguous(), valid.contiguous(), scene.mat_row.contiguous()]
    args = _build.GBufferArgs(attrs=keep[0].data_ptr(), valid=keep[1].data_ptr(), mat_row=keep[2].data_ptr(),
                              width=W, height=H, nm=nm, row_len=row_len, n_tex=1)
    textured = textures is not None
    nmap = textured and scene.texture_slots[1] and depth is not None and inverse_view_projection is not None
    quad = textured and textures.texels_quad is not None
    if textured:
        n = textures.texels.shape[0]
        nt = textures.mip_count.shape[0]
        tabled = [(textures.texels, torch.uint8, (n, 4), "texels"),
                  (textures.mip_rows, torch.int32, (nt * tex_mod.MAX_MIPS, 4), "mip_rows")]
        if quad:
            tabled.append((textures.texels_quad, torch.uint8, (n, 16), "texels_quad"))
        ptrs = []
        for t, dtype, shape, what in tabled:
            _build.expect(t, dtype, shape, f"gbuffer {what}")
            t = t.contiguous()
            if t.data_ptr() % 16:  # rows are read with 16-byte loads
                t = t.clone()
            keep.append(t)
            ptrs.append(t.data_ptr())
        args.texels, args.mip_rows = ptrs[0], ptrs[1]
        if quad:
            args.quads = ptrs[2]
        args.n_tex = nt
        args.slots = sum(1 << i for i, s in enumerate(scene.texture_slots) if s)
        args.meta = int(scene.has_texture_meta and n < (1 << 24))
    if nmap:
        _build.expect(depth, torch.float32, (H, W), "gbuffer depth")
        if H < 2 or W < 2:
            raise ValueError(f"gbuffer: the tangent frame needs a frame of 2x2 pixels or more, got {W}x{H}")
        keep.append(depth.contiguous())
        args.depth = keep[-1].data_ptr()
        args.ivp[:] = [float(x) for x in np.asarray(inverse_view_projection, dtype=np.float32).reshape(16)]
    g0 = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    g1 = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    valid_out = torch.empty((H, W), dtype=torch.bool, device=dev)
    shaded = torch.zeros(1, dtype=torch.int64, device=dev)
    args.g0, args.g1, args.valid_out, args.count = g0.data_ptr(), g1.data_ptr(), valid_out.data_ptr(), shaded.data_ptr()
    rc = _build.lib().gbuffer_launch(args, int(textured), int(nmap), int(quad), _build.stream_ptr(attrs_img))
    _build.LAUNCHES["gbuffer"] += 1
    _build.check(rc, "gbuffer")
    return g0, g1, valid_out, shaded


def gbuffer_plain(attrs_img, valid, scene, textures=None, *, depth=None, inverse_view_projection=None):
    """Plain torch G-buffer: gbuffer_from_attrs' contract (without the
    count), op by op as the kernel computes it.  Returns (g0, g1, valid)."""
    normal = attrs_img[..., 0:3]
    mat = attrs_img[..., 7].to(torch.int64)
    nrm = normal / torch.clamp_min(torch.sqrt(cullmath.dot3(normal, normal))[..., None], 1e-20)
    # one megarow per pixel: gathered, or broadcast from a one-material
    # table (where the gather would only read one row, and costs as much
    # as any: every pixel hits the same few cache lines).  The reference
    # fetches tables of up to 16 by a masked sum over them (out-of-range
    # ids giving zero rows), a workaround for the TPU's gather; here every
    # id is in range -- uncovered pixels carry attribute 0, covered ones
    # their draw's material index -- so the rows are the same
    nm = scene.mat_row.shape[0]
    row = scene.mat_row[0].expand(*mat.shape, -1) if nm == 1 else scene.mat_row[mat]
    if textures is not None:
        uv = attrs_img[..., 3:5]
        albedo, specgloss, emissive, nmap, tex_ids = _sample_materials(scene, textures, row, uv, attrs_img[..., 12])
        if nmap is not None and depth is not None and inverse_view_projection is not None:
            h, w = depth.shape
            tdir, bdir = _screen_space_tbn(_world_position(depth, inverse_view_projection, w, h), uv, nrm)
            mapped = nmap[..., 0:1] * tdir + nmap[..., 1:2] * bdir + nmap[..., 2:3] * nrm
            mapped = mapped / torch.clamp_min(torch.sqrt(cullmath.dot3(mapped, mapped))[..., None], 1e-20)
            nrm = torch.where((tex_ids[..., 1] > 0)[..., None], mapped, nrm)
        post = attrs_img[..., 8].to(torch.int32)
        valid = valid & ~((post > 0) & (albedo[..., 3] < 0.5))
    else:
        albedo, specgloss, emissive = row[..., 0:4], row[..., 4:8], row[..., 8:11]
    emissivef = cullmath.dot3(emissive, _LUM) / (cullmath.dot3(albedo[..., :3], _LUM) + 1e-3)
    g0 = torch.cat([cullmath.to_srgb(albedo[..., :3]), cullmath.div(torch.log2(1.0 + emissivef), 5.0)[..., None]],
                   dim=-1)
    g1 = torch.cat([cullmath.oct_encode(nrm) * 0.5 + 0.5, specgloss[..., 3:4],
                    torch.zeros_like(specgloss[..., :1])], dim=-1)
    v4 = valid[..., None]
    return torch.where(v4, g0, 0.0), torch.where(v4, g1, 0.0), valid


def pack_gbuffer(g0, g1, valid):
    """The G-buffer planes quantized to the reference's storage encodings
    and packed into two i32 planes (shade.py:340): g0 as rgba8, g1's
    first three channels as 10/10/10 with `valid` in bit 30.  torch has no
    full u32 arithmetic, so the words are built in int64 and wrapped to
    i32 (two's complement: bits 24-31 of p0 make it negative).  Invalid
    pixels pack to exactly 0, so a sum of disjoint owner planes is their
    union bit for bit.  Returns (p0, p1) i32 [H, W]."""
    q0 = torch.round(torch.clamp(g0, 0.0, 1.0) * 255.0).to(torch.int64)
    p0 = q0[..., 0] | (q0[..., 1] << 8) | (q0[..., 2] << 16) | (q0[..., 3] << 24)
    q1 = torch.round(torch.clamp(g1[..., :3], 0.0, 1.0) * 1023.0).to(torch.int64)
    p1 = q1[..., 0] | (q1[..., 1] << 10) | (q1[..., 2] << 20) | (valid.to(torch.int64) << 30)
    p0, p1 = torch.where(valid, p0, 0), torch.where(valid, p1, 0)
    return torch.where(p0 >= 1 << 31, p0 - (1 << 32), p0).to(torch.int32), p1.to(torch.int32)


def unpack_gbuffer(p0, p1):
    """pack_gbuffer's inverse (shade.py:364): (g0 [H,W,4], g1 [H,W,4] with
    a zero 4th channel, valid [H,W] bool).  Each channel is multiplied by
    the f32 constant 1/255 or 1/1023, as the reference does (:370, :373),
    not divided."""
    p0 = p0.to(torch.int64) & 0xFFFFFFFF
    p1 = p1.to(torch.int64)
    g0 = torch.stack([((p0 >> s) & 255).to(torch.float32) * (1.0 / 255.0) for s in (0, 8, 16, 24)], dim=-1)
    c1 = [((p1 >> s) & 1023).to(torch.float32) * (1.0 / 1023.0) for s in (0, 10, 20)]
    return g0, torch.stack(c1 + [torch.zeros_like(c1[0])], dim=-1), ((p1 >> 30) & 1) > 0


def ndc_planes(width: int, height: int, device):
    """NDC x [W] and y [H] of the pixel centers (shade.py:390-393), each
    through one IEEE division on every device."""
    x = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return cullmath.div(x, float(width)) * 2.0 - 1.0, 1.0 - cullmath.div(y, float(height)) * 2.0


def _lit_color(g0, g1, depth, *, camera_position, sun_direction, inverse_view_projection,
               width: int, height: int, shadow_term=None):
    """Sun N.L + Blinn-Phong + ambient + emissive (shade.py:378), the sun
    terms scaled by `shadow_term` [H, W] (None: unshadowed)."""
    albedo = cullmath.from_srgb(g0[..., :3])
    emissive = albedo * (torch.exp2(g0[..., 3] * 5.0) - 1.0)[..., None]
    normal = cullmath.oct_decode(g1[..., :2] * 2.0 - 1.0)
    sun = [float(c) for c in sun_direction]  # host constants: no copy to the device
    ndotl = torch.clamp_min(cullmath.dot3(normal, sun), 0.0)

    wpos = _world_position(depth, inverse_view_projection, width, height)
    view = torch.stack([float(c) - wpos[..., i] for i, c in enumerate(camera_position)], dim=-1)
    view = view / torch.clamp_min(torch.sqrt(cullmath.dot3(view, view))[..., None], 1e-20)
    halfv = torch.stack([view[..., i] + sun[i] for i in range(3)], dim=-1)
    halfv = halfv / torch.clamp_min(torch.sqrt(cullmath.dot3(halfv, halfv))[..., None], 1e-20)
    ndoth = torch.clamp_min(cullmath.dot3(normal, halfv), 0.0)
    gloss = g1[..., 2]
    specular = torch.pow(torch.clamp_min(ndoth, 1e-6), 1.0 + 63.0 * gloss) * gloss

    ambient, shadow_ambient, sun_intensity = 0.07, 0.05, 2.5
    if shadow_term is None:  # a term of 1: min(1 + shadow_ambient, 1) = 1
        lit, specular = ndotl, specular
    else:
        lit, specular = ndotl * torch.clamp_max(shadow_term + shadow_ambient, 1.0), specular * shadow_term
    color = albedo * (lit * sun_intensity + ambient)[..., None]
    color = color + specular[..., None] * sun_intensity
    return color + emissive


def composite(g0, g1, depth, valid, *, camera_position, sun_direction, inverse_view_projection,
              width: int, height: int, shadow=None, bloom=None, transmission=None):
    """G-buffer -> tonemapped, debanded image [H,W,3] (shade.py:420);
    `shadow` is the sun's shadow term [H, W] or None (unshadowed), `bloom`
    the full-resolution bloom [H, W, 3] or None.  `transmission` = (g0t,
    g1t, depth_t, valid_t), the transmission class's own layer, lit
    unshadowed: where its surface is nearer than the opaque one
    (reverse-Z: greater) or over the background, the colour becomes the
    mean of the two (shade.py:460-475)."""
    light = dict(camera_position=camera_position, sun_direction=sun_direction,
                 inverse_view_projection=inverse_view_projection, width=width, height=height)
    color = _lit_color(g0, g1, depth, shadow_term=shadow, **light)
    if bloom is not None:
        color = color + bloom * 0.1
    color = torch.where(valid[..., None], color, 0.0)
    if transmission is not None:
        g0t, g1t, depth_t, valid_t = transmission
        tcol = _lit_color(g0t, g1t, depth_t, **light)
        t_front = valid_t & ((depth_t > depth) | ~valid)
        color = torch.where(t_front[..., None], color * 0.5 + tcol * 0.5, color)
    dev = depth.device
    xy = torch.stack([
        torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(depth.shape),
        torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(depth.shape),
    ], dim=-1)
    deband = cullmath.gradient_noise(xy) * 2.0 - 1.0
    return cullmath.tonemap(color) + (deband * (0.5 / 255.0))[..., None]


def _hash_color(h):
    """u32 hash (int64 tensor of u32 values) -> rgb in [0, 1]
    (shade.py:482): every step reduced mod 2^32 as the reference's u32
    arithmetic wraps."""
    m = 0xFFFFFFFF
    h = ((h + 0x7ED55D16) + (h << 12)) & m
    h = ((h ^ 0xC761C23C) ^ (h >> 19)) & m
    h = ((h + 0x165667B1) + (h << 5)) & m
    h = ((h + 0xD3A2646C) ^ (h << 9)) & m
    h = ((h + 0xFD7046C5) + (h << 3)) & m
    h = ((h ^ 0xB55A4F09) ^ (h >> 16)) & m
    return torch.stack([cullmath.div(((h >> s) & 255).to(torch.float32), 255.0) for s in (0, 8, 16)], dim=-1)


def debug_visualize(fb, tc, setup, mode: str = "meshlet"):
    """Debug colours (shade.py:499): 'meshlet' hashes each pixel's meshlet
    id, 'draw' its draw id, 'depth' shows the reverse-Z depth scaled by its
    maximum.  `tc` and `setup` are every pass's cluster metadata and setup
    outputs concatenated in fragment-id order (render.frame.debug_inputs);
    uncovered pixels are black."""
    valid = fb.vis != INVALID_FRAG
    if mode == "depth":
        d = fb.depth / torch.clamp_min(fb.depth.max(), 1e-8)
        return torch.where(valid[..., None], torch.stack([d, d, d], dim=-1), 0.0)
    k = setup["tri_k"][torch.where(valid, fb.vis, 0).to(torch.int64)]
    key = tc["draw_id" if mode == "draw" else "mi"][k]
    return torch.where(valid[..., None], _hash_color(key.to(torch.int64) & 0xFFFFFFFF), 0.0)
