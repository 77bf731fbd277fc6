"""The shadow term's filter (niagara_tpu/ops/shadow.py): `shadow_blur`
(:542), the depth-aware bilateral blur the sun map's resolve applies.
The ray-traced path (`trace_any_hit`, `refit_tlas`) and
`checkerboard_fill` are not ported (ROADMAP A16).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cullmath

SHADOW_BLUR_KERNEL = 10


def shadow_blur(shadow, d_small, znear: float):
    """Depth-aware separable bilateral blur (shadow.py:542-564, the
    reference's shadowblur.comp.glsl:36-58): KERNEL taps per side, weight
    exp2(-i^2/50) x exp2(-|d_i - (d + dgrad*i)| * 100) on linear depth,
    dgrad predicted from the first neighbour when within 0.1.  Neighbours
    wrap around the image edges, as jnp.roll does."""
    lin = cullmath.rdiv(znear, torch.where(torch.abs(d_small) < 1e-20, 1e-20, d_small))
    for dim in (1, 0):  # horizontal, then vertical
        acc, accw = shadow, torch.ones_like(shadow)
        for sign in (-1, 1):
            dnext = torch.roll(lin, -sign, dim)
            dgrad = torch.where(torch.abs(lin - dnext) < 0.1, dnext - lin, 0.0)
            for i in range(1, SHADOW_BLUR_KERNEL + 1):
                sv = torch.roll(shadow, -sign * i, dim)
                dv = torch.roll(lin, -sign * i, dim)
                fw = float(np.exp2(-i * i / 50.0)) * torch.exp2(-torch.abs(dv - (lin + dgrad * i)) * 100.0)
                acc = acc + sv * fw
                accw = accw + fw
        shadow = acc / accw
    return shadow
