"""G-buffer encode and composite (niagara_tpu/ops/shade.py):
`gbuffer_from_attrs` (:260) with its material fetch (`_mat_rows` :159,
here one gather), texture sampling (`_sample_materials` :173,
albedo/specular/emissive slots) and the shade-time alpha discard
(:319); `_lit_color` (:378) and `composite` (:420) without shadow,
bloom or transmission.  Normal maps
(slot 1, the screen-space tangent frame) are not ported: a scene whose
materials carry one raises.
"""

from __future__ import annotations

import torch

from ..render import textures as tex_mod
from . import cullmath

_LUM = (0.3, 0.6, 0.1)


def _sample_materials(scene, textures, row, uv, duv):
    """Material factors of the per-pixel megarows `row` times their
    sampled textures (shade.py:173).  Returns (albedo, specgloss,
    emissive)."""
    albedo, specgloss, emissive = row[..., 0:4], row[..., 4:8], row[..., 8:11]
    tex_ids = row[..., 11:15].to(torch.int32)
    mip = tex_mod.select_mip_from_area(duv, torch.clamp_min(row[..., 15], 1.0))
    meta0 = None
    if scene.has_texture_meta and textures.texels.shape[0] < (1 << 24):
        meta0 = tuple(row[..., 16 + i].to(torch.int32) for i in range(4))

    def tex(idx, meta=None):
        return tex_mod.sample(textures, tex_ids[..., idx], uv, mip, meta=meta)

    slots = scene.texture_slots
    if slots[1]:
        raise NotImplementedError("normal-mapped materials are not ported (screen-space tangent frame)")
    if slots[0]:
        t = tex(0, meta=meta0)
        albedo = albedo * torch.where((tex_ids[..., 0] > 0)[..., None],
                                      torch.cat([cullmath.from_srgb(t[..., :3]), t[..., 3:]], dim=-1), 1.0)
    if slots[2]:
        specgloss = specgloss * torch.where((tex_ids[..., 2] > 0)[..., None], cullmath.from_srgb(tex(2)), 1.0)
    if slots[3]:
        emissive = emissive * torch.where((tex_ids[..., 3] > 0)[..., None], cullmath.from_srgb(tex(3)[..., :3]), 1.0)
    return albedo, specgloss, emissive


def gbuffer_from_attrs(attrs_img, valid, scene, textures=None):
    """Dense G-buffer from the shade kernel's attribute planes [H,W,13]:
    g0 = srgb albedo + log emissive, g1 = oct normal + gloss.  With
    `textures` (render.textures.TextureTable on the device) it samples the
    materials' textures and discards post-pass pixels whose albedo alpha
    is under 0.5.  Returns (g0, g1, valid)."""
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
        albedo, specgloss, emissive = _sample_materials(scene, textures, row, attrs_img[..., 3:5], attrs_img[..., 12])
        post = attrs_img[..., 8].to(torch.int32)
        valid = valid & ~((post > 0) & (albedo[..., 3] < 0.5))
    else:
        albedo, specgloss, emissive = row[..., 0:4], row[..., 4:8], row[..., 8:11]
    emissivef = cullmath.dot3(emissive, _LUM) / (cullmath.dot3(albedo[..., :3], _LUM) + 1e-3)
    g0 = torch.cat([cullmath.to_srgb(albedo[..., :3]), (torch.log2(1.0 + emissivef) / 5.0)[..., None]], dim=-1)
    g1 = torch.cat([cullmath.oct_encode(nrm) * 0.5 + 0.5, specgloss[..., 3:4],
                    torch.zeros_like(specgloss[..., :1])], dim=-1)
    v4 = valid[..., None]
    return torch.where(v4, g0, 0.0), torch.where(v4, g1, 0.0), valid


def _lit_color(g0, g1, depth, *, camera_position, sun_direction, inverse_view_projection,
               width: int, height: int):
    """Sun N.L + Blinn-Phong + ambient + emissive, unshadowed (shade.py:378)."""
    dev = depth.device
    albedo = cullmath.from_srgb(g0[..., :3])
    emissive = albedo * (torch.exp2(g0[..., 3] * 5.0) - 1.0)[..., None]
    normal = cullmath.oct_decode(g1[..., :2] * 2.0 - 1.0)
    sun = [float(c) for c in sun_direction]  # host constants: no copy to the device
    ndotl = torch.clamp_min(cullmath.dot3(normal, sun), 0.0)

    # world position from reverse-Z depth
    ndc_x = ((torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0)[None, :]
    ndc_y = (1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height * 2.0)[:, None]
    ivp = inverse_view_projection
    clip = (ndc_x.expand(depth.shape), ndc_y.expand(depth.shape), depth)
    wposh = [clip[0] * float(ivp[i, 0]) + clip[1] * float(ivp[i, 1]) + clip[2] * float(ivp[i, 2])
             + float(ivp[i, 3]) for i in range(4)]
    wdiv = torch.where(torch.abs(wposh[3]) < 1e-20, 1e-20, wposh[3])
    wpos = torch.stack(wposh[:3], dim=-1) / wdiv[..., None]

    view = torch.stack([float(c) - wpos[..., i] for i, c in enumerate(camera_position)], dim=-1)
    view = view / torch.clamp_min(torch.sqrt(cullmath.dot3(view, view))[..., None], 1e-20)
    halfv = torch.stack([view[..., i] + sun[i] for i in range(3)], dim=-1)
    halfv = halfv / torch.clamp_min(torch.sqrt(cullmath.dot3(halfv, halfv))[..., None], 1e-20)
    ndoth = torch.clamp_min(cullmath.dot3(normal, halfv), 0.0)
    gloss = g1[..., 2]
    specular = torch.pow(torch.clamp_min(ndoth, 1e-6), 1.0 + 63.0 * gloss) * gloss

    ambient, shadow_ambient, sun_intensity = 0.07, 0.05, 2.5
    color = albedo * (ndotl * min(1.0 + shadow_ambient, 1.0) * sun_intensity + ambient)[..., None]
    color = color + specular[..., None] * sun_intensity
    return color + emissive


def composite(g0, g1, depth, valid, *, camera_position, sun_direction, inverse_view_projection,
              width: int, height: int):
    """G-buffer -> tonemapped, debanded image [H,W,3] (shade.py:420)."""
    color = _lit_color(g0, g1, depth, camera_position=camera_position, sun_direction=sun_direction,
                       inverse_view_projection=inverse_view_projection, width=width, height=height)
    color = torch.where(valid[..., None], color, 0.0)
    dev = depth.device
    xy = torch.stack([
        torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(depth.shape),
        torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(depth.shape),
    ], dim=-1)
    deband = cullmath.gradient_noise(xy) * 2.0 - 1.0
    return cullmath.tonemap(color) + (deband * (0.5 / 255.0))[..., None]
