"""Capacity policy of the headline frame (niagara_tpu/render/presets.py)."""

from __future__ import annotations


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


def small_capacities() -> dict:
    """Budgets of the 256x128 small-scene frame (cooker.small_scene_draws),
    sized like tests/test_city.py's reduced frame."""
    return dict(
        cmd_capacity=1 << 8, cluster_capacity=1 << 11,
        candidate_capacity=1 << 12, late_candidate_capacity=1 << 12,
        pair_capacity=1 << 15, tri_capacity=1 << 15,
        late_cluster_capacity=1 << 10, late_tri_capacity=1 << 13,
    )
