"""The animated tail: its motion and its band of the sun map.

The card's tools and the tests share these: chip_smoke.py's sun phases,
tests/test_torch_gate.py's animated step and stage-timer frames.  The
last 2% of a scene's draws move by `sun_delta(t)`; `SunTail.update(t)`
moves them, renders their dirty band of the static sun map and splices it
into the packed table.  The module keeps its name because the benchmark's
frozen test (framebench/test_framebench_frozen.py) imports `sun_delta`
from here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import sunmap
from .render import presets
from .utils.profiling import stage_marker


def sun_delta(t: float, dev):
    """bench.py's tail motion at time t: 2 (sin t, 0, 1 - cos t), f32."""
    t = np.float32(t)
    return torch.tensor(np.array([np.sin(t), 0.0, 1.0 - np.cos(t)], np.float32) * np.float32(2.0), device=dev)


def animate_tail(sc, t: float):
    """Every draw of `sc` (the animated tail, slice_draws) moved by
    sun_delta(t) (bench.py:184-193)."""
    d = sun_delta(t, sc.draw_position.device)
    xf = sc.draw_xform_row.clone()
    xf[:, 0:3] += d
    return dataclasses.replace(sc, draw_position=sc.draw_position + d, draw_xform_row=xf)


def animate_scene(sc, static_n: int, t: float):
    """The draws from static_n on moved by sun_delta(t) (bench.py:325-332)."""
    d = sun_delta(t, sc.draw_position.device)
    pos, xf = sc.draw_position.clone(), sc.draw_xform_row.clone()
    pos[static_n:] += d
    xf[static_n:, 0:3] += d
    return dataclasses.replace(sc, draw_position=pos, draw_xform_row=xf)


@dataclasses.dataclass
class SunTail:
    """The static sun map and the animated tail's band update
    (bench.py:153-268): `update(t)` moves the tail, renders its band of
    the map and splices the band into the cached pack table."""

    sf: dict
    static: torch.Tensor
    packed_static: torch.Tensor
    tail: object
    window: tuple
    caps: dict
    map_wh: int
    texel: float

    def update(self, t: float, stages=None):
        """(packed table, the update's drops); `stages` gets the
        boundaries "tail move", the band's "sun cull", "sun setup", "sun
        raster" (ops/sunmap.render_sun_map) and "pack_band"."""
        mark = stage_marker(stages)
        m, (row0, rows) = self.map_wh, self.window
        a, b = row0 * 8, (row0 + rows) * 8
        tail_t = animate_tail(self.tail, t)
        mark("tail move")
        band, drop = sunmap.update_sun_map(tail_t, self.sf, self.static, None, map_w=m, map_h=m,
                                           texel_world=self.texel, row_window=self.window, stages=stages, **self.caps)
        packed = sunmap.pack_band(self.packed_static, band, a, m, row_above=self.static[a - 1] if a > 0 else None,
                                  row_below=self.static[b] if b < m else None)
        mark("pack_band")
        return packed, drop


def tail_window(sf, tail, map_wh: int, texel: float) -> tuple:
    """The animated tail's dirty band of tile rows (bench.py:224-244): its
    spheres at rest plus the motion bound of 4 world units and two
    texels."""
    return sunmap.dirty_tile_rows(sf, tail.draw_position, tail.draw_mesh_row[:, 3] * tail.draw_scale, map_wh,
                                  margin=4.0 + 2.0 * texel)


def sun_tail(ds, sf, static, static_n: int, map_wh: int, texel: float, sun_caps: dict) -> SunTail:
    """The tail [static_n, D) of `ds` as its own sliced scene with its
    dirty band and the update budgets at tail scale
    (presets.sunmap_update_capacities)."""
    tail = ds.slice_draws(static_n, ds.num_draws)
    caps = presets.sunmap_update_capacities(ds.num_draws - static_n, sun_caps)
    return SunTail(sf=sf, static=static, packed_static=sunmap.pack_sun_map(static), tail=tail,
                   window=tail_window(sf, tail, map_wh, texel), caps=caps, map_wh=map_wh, texel=texel)
