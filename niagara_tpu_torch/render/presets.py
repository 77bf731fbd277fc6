"""Named configurations and capacity policies (niagara_tpu/render/presets.py):
`settings_for` and `frame_overrides` map the reference's staged configs
0-5 onto RenderSettings and FrameConfig overrides (presets.py:26-53); the
capacity policies of the 1M-draw headline frame, the sun map's per-frame
update, the small test frame, and `scene_capacities` for cooked scenes
such as the glTF city.

The configs: 0 renders everything, no culling, every draw at LOD 0 in one
pass; 1 frustum, cone and LOD culling in one pass; 2 adds two-pass
occlusion culling; 3 the textured, alpha-classed content (the scene's own
classes); 4 and 5 animation and sun shadows.  Configs 1 and 2 give the
same depth (occlusion removes only what loses the depth test anyway).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from .camera import RenderSettings

#: config id -> RenderSettings field overrides (presets.py:26)
_SETTINGS = {
    0: dict(culling=False, lod=False, occlusion=False, cluster_occlusion=False, cluster_backface=False),
    1: dict(occlusion=False, cluster_occlusion=False),
    2: dict(),
    3: dict(),
    4: dict(),
    5: dict(),
}

#: config id -> FrameConfig field overrides, applied by the caller (presets.py:37)
_FRAME = {
    0: dict(occlusion_two_pass=False, post_passes=1),
    1: dict(occlusion_two_pass=False),
    2: dict(),
    3: dict(),  # textures and the alpha class follow the scene's content
    4: dict(shadows=True),
    5: dict(shadows=True),
}


def settings_for(config: int, base: RenderSettings | None = None) -> RenderSettings:
    """`base` (default RenderSettings()) with config N's toggles."""
    return replace(base or RenderSettings(), **_SETTINGS[int(config)])


def frame_overrides(config: int) -> dict:
    """Config N's FrameConfig fields (a fresh dict)."""
    return dict(_FRAME[int(config)])


# pair-emission class budgets (tiny2, small, midA, midB) of the 1M-draw
# headline frame.  The reference leaves them to emit_pairs' tri-capacity
# fractions (T/2, T/8, T/64, T/1024 = 327,680 / 81,920 / 10,240 / 640 at
# T = 640K), tuned on its kitten.  The port's torus puts more of its
# triangles across 3-40 tiles: its steady-state demand per frame on an
# H100 (1M draws, 1920x1080) is up to 240,830 / 105,782 / 41,443 / 1,424,
# so small, midA and midB are raised to ~1.5x that and tiny2 keeps the
# reference's early-pass value.
HEADLINE_PAIR_CLASS_CAPS = (327_680, 163_840, 65_536, 2_048)

# late-pass pair budget of the 1M-draw headline frame.  The reference's
# 262,144 holds the alpha class it measured on the kitten (~130K pairs,
# presets.py:82-86).  The port's torus draws in the alpha class render
# double-sided (no backface or cone cull), so their late pass carries about
# twice the 1/8 share: 279,328 pairs in a steady alpha frame on an H100 (1M
# draws, 1920x1080), 17,184 over the reference's budget.  Raised to ~1.5x
# that.
HEADLINE_LATE_PAIR_CAPACITY = 416 * 1024


def headline_capacities(draw_count: int) -> dict:
    """The reference's headline budgets (presets.py:56), plus, above 300K
    draws, the raised pair-class budgets above (`pair_class_caps`, the
    reference FrameConfig's field) and the raised late pair budget.  The first two frames from a cold
    start still overflow, as in the reference after a camera cut
    (frame.py:85-89): frame 0's late pass gets the whole unoccluded set,
    frame 1's early pass re-renders it, then visibility settles."""
    big = draw_count > 300_000
    caps = dict(
        cmd_capacity=1 << 16 if big else 1 << 14,
        cluster_capacity=1 << 16,
        candidate_capacity=1 << 17 if big else 1 << 16,
        late_candidate_capacity=1 << 17 if big else 1 << 16,
        tri_capacity=640 * 1024,
        pair_capacity=1280 * 1024,
        late_cluster_capacity=1 << 14,
        late_tri_capacity=1 << 18,
        late_pair_capacity=1 << 18,
    )
    if big:
        caps["pair_class_caps"] = HEADLINE_PAIR_CLASS_CAPS
        caps["late_pair_capacity"] = HEADLINE_LATE_PAIR_CAPACITY
    return caps


# triangle and pair budgets of the sun map's per-frame update of an animated
# tail.  The reference's 2^18 of each (presets.py:106-110) holds its
# 20,000-draw tail on the kitten (~132K triangles, ~174K pairs).  The port's
# torus at the map's texel LOD (its coarsest) gives 14.0 triangles and 19.4
# pairs a tail draw (400 tail draws of a 20,000-draw alpha scene, CPU run:
# 5,617-5,622 and 7,736-7,755), ~281K and ~388K for the benchmark's tail:
# raised to ~1.9x and ~2x that, the triangles at the static build's 2^19
# (the u32 pair key of a 4,096-tile map).
SUNMAP_UPDATE_TRI_CAPACITY, SUNMAP_UPDATE_PAIR_CAPACITY = 1 << 19, 3 << 18


def sunmap_update_capacities(anim_n: int, sun_caps: dict) -> dict:
    """Per-frame sun-map update budgets at animated-tail scale
    (presets.py:90): for a tail of `anim_n` draws, commands ~1.6x and
    clusters ~3x the tail's draws (powers of two), as the reference; the
    triangle and pair budgets raised for the torus (above); none above the
    static build's `sun_caps`."""
    caps = dict(sun_caps)
    if anim_n:
        caps.update(
            cmd_capacity=max(1 << 12, 1 << (anim_n - 1).bit_length()),
            cluster_capacity=min(sun_caps["cluster_capacity"], max(1 << 13, 1 << (3 * anim_n // 2 - 1).bit_length())),
            tri_capacity=min(sun_caps["tri_capacity"], SUNMAP_UPDATE_TRI_CAPACITY),
            pair_capacity=min(sun_caps["pair_capacity"], SUNMAP_UPDATE_PAIR_CAPACITY),
        )
    return caps


def small_capacities() -> dict:
    """Budgets of the 256x128 small-scene frame (cooker.small_scene_draws),
    sized like tests/test_city.py's reduced frame."""
    return dict(
        cmd_capacity=1 << 8, cluster_capacity=1 << 11,
        candidate_capacity=1 << 12, late_candidate_capacity=1 << 12,
        pair_capacity=1 << 15, tri_capacity=1 << 15,
        late_cluster_capacity=1 << 10, late_tri_capacity=1 << 13,
    )


def scene_capacities(geometry, draws) -> dict:
    """Data-driven budgets of a cooked scene (presets.py:115): emitted draws
    bounded by the draw count and clusters by the sum over draws of their
    finest LOD's meshlets (`total`); triangles 4x and pairs 2x that in the
    hard-bound window, clamped to measured demand with headroom in the
    mid-size one (the city); the giant pair class scaled with the scene.
    Scenes past the mid-size window take the headline budgets.  Keys are
    FrameConfig fields, `giant_capacity` among them."""
    lod0 = geometry.meshes.lod_meshlet_count[:, 0]
    total = int(lod0[np.asarray(draws.mesh_index)].sum())
    if draws.count > 300_000 or total > (1 << 19):
        return headline_capacities(draws.count)

    def p2(x, lo, hi=1 << 30):
        return min(hi, max(lo, 1 << (max(int(x), 1) - 1).bit_length()))

    cluster = p2(total, 1 << 12)
    if total <= (1 << 17):
        cand = cluster
        tri = p2(4 * total, 1 << 14, 1 << 19)
    else:
        cand = min(cluster, 1 << 17)
        cluster = min(cluster, 1 << 15)
        tri = 1 << 17
    return dict(
        cmd_capacity=p2(draws.count, 1 << 12),
        cluster_capacity=cluster,
        candidate_capacity=cand,
        late_candidate_capacity=cand,
        late_cluster_capacity=max(1 << 12, cluster // 2),
        tri_capacity=tri,
        late_tri_capacity=max(1 << 14, tri // 2),
        pair_capacity=2 * tri,
        late_pair_capacity=max(1 << 15, tri),
        giant_capacity=p2(total // 256, 128, 256),
    )
