"""Two-pass culling of niagara_tpu_torch against the JAX reference.

Early draw cull + cluster_cull_direct, then the depth pyramid and the late
draw cull (num_classes=1) + cluster_cull_direct_multi with the visibility
write-back, on the same seeded inputs; then the alpha-classed scene's
merged late pass (draw_cull(num_classes=2), cluster_cull_direct_multi with
class groups).  Every output is an integer or a mask and must match
exactly; the pyramid (min and selection only) too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.ops import cull as jcull
from niagara_tpu.ops import pyramid as jpyramid
from niagara_tpu.ops import raster as jraster
from niagara_tpu.render.camera import Camera, RenderSettings, make_cull_params
from niagara_tpu_torch import scene
from niagara_tpu_torch.ops import cull, pyramid, raster
from niagara_tpu_torch.render import camera
from test_torch_scene import CAPS, H, W, alpha_parity_scene, parity_scene


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64), err_msg=what)


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    _, ds = parity_scene(tmp_path_factory.mktemp("mesh"))
    tds = scene.from_numpy(ds, "cpu")
    levels, ph, pw = jpyramid.pyramid_shape(W, H)
    jp, _ = make_cull_params(Camera(), W, H, pw, ph, RenderSettings())
    tp, _ = camera.make_cull_params(camera.Camera(), W, H, pw, ph, camera.RenderSettings())
    rng = np.random.default_rng(11)
    draw_vis = (rng.random(ds.num_draws) < 0.5).astype(np.int32)
    n_words = -(-max(ds.meshlet_visibility_count, 64) // 64) * 2
    vis_words = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    # an occluder 6 units ahead over the left half of the screen
    depth = np.zeros((H, W), np.float32)
    depth[:, : W // 2] = np.float32(0.1) / np.float32(6.0)
    return ds, tds, jp, tp, draw_vis, vis_words, depth, (levels, ph, pw)


def test_pyramid_matches_reference(setting):
    *_, depth, (levels, ph, pw) = setting
    ref = np.asarray(jpyramid.build_pyramid(jnp.asarray(depth), levels, ph, pw))
    np.testing.assert_array_equal(pyramid.build_pyramid(torch.from_numpy(depth), levels, ph, pw).numpy(), ref)


@pytest.mark.parametrize("late", [False, True])
def test_two_pass_cull_matches_reference(setting, late):
    ds, tds, jp, tp, draw_vis, vis_words, depth, (levels, ph, pw) = setting
    if late:
        j_atlas = jpyramid.build_pyramid(jnp.asarray(depth), levels, ph, pw)
    else:
        j_atlas = jnp.zeros((levels, ph, pw), jnp.float32)
    t_atlas = torch.from_numpy(np.array(j_atlas))
    kw = dict(late=late, pyramid_shape=(ph, pw))
    ncls = dict(num_classes=1) if late else {}

    emit, lod, vis = jcull.draw_cull(ds, jp, jnp.asarray(draw_vis), j_atlas, **kw, **ncls)
    t_dvb = torch.from_numpy(draw_vis)
    t_emit, t_lod, t_vis = cull.draw_cull(tds, tp, t_dvb, t_atlas, **kw)
    for a, b, what in ((emit, t_emit, "emit"), (lod, t_lod, "lod"), (vis, t_vis, "visible")):
        _eq(a, b, what)
    assert int(np.asarray(emit).sum()) > 5

    caps = dict(draw_capacity=CAPS["cmd_capacity"],
                cluster_capacity=CAPS["late_cluster_capacity"] if late else CAPS["cluster_capacity"],
                candidate_capacity=CAPS["late_candidate_capacity"] if late else CAPS["candidate_capacity"])
    t_words = torch.from_numpy(vis_words.astype(np.int64))
    got = cull.cluster_cull_direct(tds, tp, t_emit, t_lod, t_dvb, t_words, t_atlas, **kw, **caps)
    if late:
        groups, words, n_draws, ddrop, cdrop, n_cand = jcull.cluster_cull_direct_multi(
            ds, jp, emit, lod, jnp.asarray(draw_vis), jnp.asarray(vis_words), j_atlas, num_classes=1, **kw, **caps)
        cdraw, cmi, count = groups[0]
        ref = (cdraw, cmi, count, words, n_draws, ddrop, cdrop, n_cand)
        assert not np.array_equal(np.asarray(words), vis_words), "late pass writes visibility back"
    else:
        ref = jcull.cluster_cull_direct(ds, jp, emit, lod, jnp.asarray(draw_vis), jnp.asarray(vis_words), j_atlas,
                                        **kw, **caps)
    names = ("cluster_draw", "cluster_mi", "count", "vis_words", "n_draws", "draw_dropped", "cluster_dropped")
    for a, b, what in zip(ref, got, names):
        _eq(a, b, what)
    if late:
        _eq(ref[-1], got[-1], "candidates")
    count = int(np.asarray(ref[2]))
    assert count > 0

    # screen-x cluster order and setup metadata
    j_draw, j_mi = jraster.order_clusters_by_x(ds, jp, ref[0], ref[1], ref[2])
    t_draw, t_mi = raster.order_clusters_by_x(tds, tp, got[0], got[1], got[2])
    _eq(j_draw, t_draw, "ordered draws")
    _eq(j_mi, t_mi, "ordered meshlets")
    jtc = jraster.transform_meta_direct(ds, j_draw, j_mi, ref[2])
    ttc = raster.transform_meta_direct(tds, t_draw, t_mi, got[2])
    for k in ("mi", "tri_count", "draw_id", "mat_index", "post_pass", "count"):
        _eq(jtc[k], ttc[k], k)
    np.testing.assert_array_equal(np.asarray(jtc["xform"]), ttc["xform"].numpy())


@pytest.mark.parametrize("class_groups", [((0, 1),), None])
def test_multi_class_late_cull_matches_reference(tmp_path_factory, class_groups):
    """The merged late pass of the alpha-classed scene: draw_cull over both
    classes (num_classes=2) and cluster_cull_direct_multi with the frame's
    one merged group (0, 1) and with the default group per class, on seeded
    draw visibility, visibility words and occluder."""
    ds, _ = alpha_parity_scene(tmp_path_factory.mktemp("mesh"))
    tds = scene.from_numpy(ds, "cpu")
    levels, ph, pw = jpyramid.pyramid_shape(W, H)
    jp, _ = make_cull_params(Camera(), W, H, pw, ph, RenderSettings())
    tp, _ = camera.make_cull_params(camera.Camera(), W, H, pw, ph, camera.RenderSettings())
    rng = np.random.default_rng(12)
    draw_vis = (rng.random(ds.num_draws) < 0.5).astype(np.int32)
    n_words = -(-max(ds.meshlet_visibility_count, 64) // 64) * 2
    vis_words = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    depth = np.zeros((H, W), np.float32)
    depth[:, : W // 2] = np.float32(0.1) / np.float32(6.0)
    j_atlas = jpyramid.build_pyramid(jnp.asarray(depth), levels, ph, pw)
    t_atlas = torch.from_numpy(np.array(j_atlas))
    kw = dict(late=True, pyramid_shape=(ph, pw))

    emit, lod, vis = jcull.draw_cull(ds, jp, jnp.asarray(draw_vis), j_atlas, num_classes=2, **kw)
    t_dvb = torch.from_numpy(draw_vis)
    t_emit, t_lod, t_vis = cull.draw_cull(tds, tp, t_dvb, t_atlas, num_classes=2, **kw)
    for a, b, what in ((emit, t_emit, "emit"), (lod, t_lod, "lod"), (vis, t_vis, "visible")):
        _eq(a, b, what)
    post = ds.draw_post_pass > 0
    assert np.asarray(emit)[post].sum() > 0 and np.asarray(emit)[~post].sum() > 0, "both classes emitted"

    caps = dict(draw_capacity=CAPS["cmd_capacity"], cluster_capacity=CAPS["late_cluster_capacity"],
                candidate_capacity=CAPS["late_candidate_capacity"], num_classes=2, class_groups=class_groups)
    ref = jcull.cluster_cull_direct_multi(ds, jp, emit, lod, jnp.asarray(draw_vis), jnp.asarray(vis_words),
                                          j_atlas, **kw, **caps)
    got = cull.cluster_cull_direct_multi(tds, tp, t_emit, t_lod, t_dvb, torch.from_numpy(vis_words.astype(np.int64)),
                                         t_atlas, **kw, **caps)
    assert len(got[0]) == len(ref[0]) == (1 if class_groups else 2)
    for g, (rg, tg) in enumerate(zip(ref[0], got[0])):
        for a, b, what in zip(rg, tg, ("cluster_draw", "cluster_mi", "count")):
            _eq(a, b, f"group {g} {what}")
    for a, b, what in zip(ref[1:], got[1:], ("vis_words", "n_draws", "draw_dropped", "cluster_dropped", "candidates")):
        _eq(a, b, what)
    counts = [int(np.asarray(c)) for _, _, c in ref[0]]
    assert all(c > 0 for c in counts), counts
    classes = ds.draw_post_pass[np.asarray(ref[0][0][0])[: counts[0]]]
    assert (classes == 0).any() and ((classes == 1).any() == bool(class_groups)), "merged group holds both classes"
