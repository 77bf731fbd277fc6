"""The ray-traced sun shadows of niagara_tpu_torch (ops/shadow.py, the
viewer's --shadows) against the JAX reference's (niagara_tpu/ops/shadow.py,
traced on XLA:CPU as tests/test_shadow.py runs it), on the CPU, from the
same seeded numpy inputs.

Exact: the port's C++ BVH builders (build_bvh, build_bvh_boxes,
refit_bvh_boxes) and the reference's, byte for byte; build_scene_rt's and
refit_tlas's fields and tables (opaque, alpha-classed with its mask rows,
with transmission draws; the refit's cached path after moving draws), and
single_blas and from_numpy, bit for bit.

The walk: trace_any_hit on the CPU is trace_plain, which rounds every op
as IEEE f32 in a fixed order; XLA:CPU contracts the reference's a*b+c into
FMAs.  A ray whose hit lies within a few ulp of a triangle's edge can
therefore land on either side: each flag that differs is accounted for by
its ray passing within EDGE_EPS = 1e-4 (in barycentric units) of an edge
of a triangle it meets at t in (t_min, t_max), computed in f64 from the
scene's f32 inputs (`_near_edge`): f32 coordinates up to 300 units carry
3e-5 ulps, which move barycentrics on the shadow LOD's ~0.5-unit edges by
under 1e-4.  MAX_FLIPS bounds how many a case may have; none of these
cases has a flip (0 of 5,888 rays, and 0 of the 24,576 rays of the
shadow_pass cases).

shadow_pass (blur and checkerboard on and off) on the reference frame's
depth: pixels whose traced ray's flag differs are accounted as above; the
rest of the unblurred term is exact, the checkerboard fill within
FILL_ATOL of the reference's (exp2 and the 4-term sum's order) away from
the traced neighbours of a flip, and the blurred term within BLUR_ATOL
outside the blur's reach (10 px a side) of a flip.

The 256x128 ray-traced frame (the parity scene, 48 torus draws, opaque,
two chained frames, bloom off) against the reference's
render_frame(bvh=...): FrameState and FrameStats exact, vis and depth as
tests/test_torch_frame.py states them, the shadow term from the frame's
own depth and the image within the limits stated at the test.  The viewer
renders --shadows on the CPU to its PNG."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from niagara_tpu.cooker import bindings as jbindings
from niagara_tpu.ops import shadow as jshadow
from niagara_tpu.render import frame as jframe
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import cooker, render_scene, scene
from niagara_tpu_torch.cooker import bindings
from niagara_tpu_torch.ops import shadow
from niagara_tpu_torch.render import camera, frame, presets
from test_torch_frame import _edge_flips
from test_torch_scene import CAPS, H, W, parity_scene

INVALID = 0x7FFFFFFF
EDGE_EPS = 1e-4
MAX_FLIPS = 3
FILL_ATOL = 1e-6
BLUR_ATOL = 1e-6
T_MIN = 1e-3
SHADOW_REACH = shadow.SHADOW_BLUR_KERNEL + 1  # a flip's reach through the blur, per axis


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """trace_plain runs ~150 small ops a step; under the parallel test
    run's other workers, torch's intra-op threads only wait on each other
    (this file took 1,045 s with them, 50 s alone), so its ops run on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bytes_equal(a, b):
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _assert_bvh_equal(got: shadow.ShadowBVH, ref):
    assert got.tlas_base == ref.tlas_base
    for f in shadow.TENSOR_FIELDS:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.shape == r.shape and g.dtype == r.dtype == np.float32, f
        assert _bytes_equal(g, r), f  # bits: skip/leaf words are NaN or denormal floats


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    return cooker.cook_procedural(str(tmp_path_factory.mktemp("mesh")))


def _scene(geometry, kind):
    """(geometry, draws, materials, mips) of a test scene: "opaque" 200 of
    the reference's PCG draws; "alpha" cooker.small_alpha_scene (7 alpha
    draws, mask rows); "glass" cooker.small_glass_scene (transmission
    draws, which get no TLAS leaf)."""
    if kind == "opaque":
        return geometry, cooker.synthesize_draws(geometry.meshes.count, draw_count=200), None, None
    g, d, mats, _, mips = (cooker.small_alpha_scene if kind == "alpha" else cooker.small_glass_scene)(geometry)
    return g, d, mats, mips


# ------------------------------------------------------------ builders


@pytest.mark.parametrize("which", ["build_bvh", "build_bvh_boxes", "refit_bvh_boxes"])
def test_bvh_builders_match_reference(geometry, which):
    """The port's library (cooker/native/bvh.cpp) against the reference's:
    the procedural torus at its shadow LOD and at LOD 0, seeded boxes."""
    if which == "build_bvh":
        m = geometry.meshes
        pos = geometry.vpos.astype(np.float32)
        for lod in (int(m.lod_rt[0]), 0):
            off, cnt = int(m.lod_index_offset[0, lod]), int(m.lod_index_count[0, lod])
            idx = geometry.indices[off:off + cnt].astype(np.uint32)
            (gn, go), (rn, ro) = bindings.build_bvh(pos, idx), jbindings.build_bvh(pos, idx)
            assert len(go) == cnt // 3 and _bytes_equal(gn, rn) and _bytes_equal(go, ro)
        return
    rng = np.random.default_rng(11)
    c = rng.uniform(-300, 300, (3000, 3)).astype(np.float32)
    e = rng.uniform(0.1, 4.0, (3000, 3)).astype(np.float32)
    for leaf in (1, 4):
        (gn, go), (rn, ro) = bindings.build_bvh_boxes(c - e, c + e, leaf), jbindings.build_bvh_boxes(c - e, c + e, leaf)
        assert _bytes_equal(gn, rn) and _bytes_equal(go, ro)
        if which == "refit_bvh_boxes":
            moved = (c + rng.normal(scale=5.0, size=c.shape).astype(np.float32))[go.astype(np.int64)]
            le = e[go.astype(np.int64)]
            got = bindings.refit_bvh_boxes(gn, moved - le, moved + le)
            assert _bytes_equal(got, jbindings.refit_bvh_boxes(rn, moved - le, moved + le))
            assert not _bytes_equal(got, gn) and _bytes_equal(got[:, 6:8], gn[:, 6:8]), "boxes move, topology stays"


@pytest.mark.parametrize("kind", ["opaque", "alpha", "glass"])
def test_build_scene_rt_and_refit_match_reference(geometry, kind):
    """build_scene_rt's ShadowBVH and static tables, then refit_tlas after
    moving 20 draws (the cached MODE_UPDATE path: same live set) and after
    changing the live set (a rebuild), each bit for bit the reference's."""
    g, d, mats, mips = _scene(geometry, kind)
    got, gst = shadow.build_scene_rt(g, d, mats, mips)
    ref, rst = jshadow.build_scene_rt(g, d, mats, mips)
    _assert_bvh_equal(got, ref)
    for k in ("blas", "tri", "tri_uv", "tri_alpha", "mesh_roots", "mesh_base", "mesh_tri_base"):
        assert _bytes_equal(gst[k], rst[k]), k
    assert gst["blas_base"] == rst["blas_base"] and gst["tri_base"] == rst["tri_base"]
    live = np.nonzero(d.post_pass < 2)[0]
    assert got.inst_row.shape[0] == len(live), "transmission draws get no TLAS leaf"
    if kind == "alpha":
        assert (got.tri_alpha[:, 6] > 0).all(), "the alpha meshes' triangles carry mask rows"
    if kind == "glass":
        assert len(live) < d.count

    moved = dataclasses.replace(d, position=d.position.copy())
    moved.position[-20:] += np.float32([3.0, -1.5, 2.0])
    cached = gst["_tlas"]["nodes"]
    got1, ref1 = shadow.refit_tlas(gst, moved), jshadow.refit_tlas(rst, moved)
    _assert_bvh_equal(got1, ref1)
    assert gst["_tlas"]["nodes"] is cached, "the refit kept the built topology"
    t0 = got1.tlas_base
    assert _bytes_equal(got1.nodes[:t0], got.nodes[:t0]) and not _bytes_equal(got1.nodes[t0:], got.nodes[t0:])
    assert _bytes_equal(got1.nodes[t0:, 6:8], got.nodes[t0:, 6:8])
    post = moved.post_pass.copy()
    post[0] = 2 if post[0] < 2 else 0
    relive = dataclasses.replace(moved, post_pass=post)
    _assert_bvh_equal(shadow.refit_tlas(gst, relive), jshadow.refit_tlas(rst, relive))
    assert gst["_tlas"]["nodes"] is not cached, "a new live set rebuilds"


def _quad(z=0.0, size=1.0):
    v = np.array([[-size, -size, z], [size, -size, z], [size, size, z], [-size, size, z]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    nodes, order = bindings.build_bvh(v, idx)
    return nodes, v[idx.reshape(-1, 3)][order]


def test_single_blas_and_from_numpy_match_reference():
    nodes, tris = _quad()
    got, ref = shadow.single_blas(nodes, tris), jshadow.single_blas(nodes, tris)
    _assert_bvh_equal(got, ref)
    _assert_bvh_equal(shadow.from_numpy(ref, "cpu"), ref)
    _assert_bvh_equal(shadow.from_numpy(jax.device_put(ref), "cpu"), ref)


def test_tlas_refit_moves_instances(geometry):
    """The port's test_shadow.py::test_tlas_refit_moves_instances: refit
    only rebuilds the instance level, and the moved instance occludes at
    its new place and no longer at its old one."""
    d = cooker.synthesize_draws(geometry.meshes.count, draw_count=2)
    d.position[:] = [[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]]
    d.scale[:] = 1.0
    d.orientation[:] = [0.0, 0.0, 0.0, 1.0]
    bvh0, static = shadow.build_scene_rt(geometry, d)
    root = static["blas_roots"][int(d.mesh_index[0])]
    # through the tube, off the torus's hole
    o = np.array([[(root[0] + root[3]) * 0.5 + (root[3] - root[0]) * 0.4, 0.0, -50.0]], np.float32)
    dirs = torch.tensor([[0.0, 0.0, 1.0]])
    assert bool(shadow.trace_any_hit(bvh0, torch.from_numpy(o), dirs, max_steps=4096)[0])
    d.position[0] = [0.0, 500.0, 0.0]
    bvh1 = shadow.refit_tlas(static, d)
    assert _bytes_equal(bvh1.nodes[:bvh1.tlas_base], bvh0.nodes[:bvh0.tlas_base])
    assert not bool(shadow.trace_any_hit(bvh1, torch.from_numpy(o), dirs, max_steps=4096)[0])
    o2 = o + np.float32([0.0, 500.0, 0.0])
    assert bool(shadow.trace_any_hit(bvh1, torch.from_numpy(o2), dirs, max_steps=4096)[0])


# ------------------------------------------------------------ the walk


def _rot64(v, q):
    qv, w = q[..., :3], q[..., 3:4]
    return v + 2.0 * np.cross(qv, np.cross(qv, v) + w * v)


def _world_soup(geometry, draws):
    """Every live draw's shadow-LOD triangles in world space, f64 [n, 3, 3]."""
    m = geometry.meshes
    pos = geometry.vpos.astype(np.float32).astype(np.float64)
    out = []
    for k in np.nonzero(draws.post_pass < 2)[0]:
        mi = int(draws.mesh_index[k])
        lod = int(m.lod_rt[mi])
        off, cnt = int(m.lod_index_offset[mi, lod]), int(m.lod_index_count[mi, lod])
        tri = pos[geometry.indices[off:off + cnt].astype(np.int64)]
        q = np.asarray(draws.orientation[k], np.float64)
        out.append((_rot64(tri, q) * float(draws.scale[k]) + draws.position[k].astype(np.float64)).reshape(-1, 3, 3))
    return np.concatenate(out)


def _near_edge(soup, o, d, t_max=1e30):
    """Smallest |barycentric margin| min(u, v, 1-u-v) over the triangles of
    `soup` the f64 ray o + t d meets in its plane at t in (T_MIN, t_max)."""
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    v0, e1, e2 = soup[:, 0], soup[:, 1] - soup[:, 0], soup[:, 2] - soup[:, 0]
    p = np.cross(d, e2)
    det = np.einsum("ij,ij->i", e1, p)
    ok = np.abs(det) > 1e-300
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - v0
    u = np.einsum("ij,ij->i", tv, p) * inv
    qv = np.cross(tv, e1)
    v = (qv @ d) * inv
    t = np.einsum("ij,ij->i", e2, qv) * inv
    margin = np.abs(np.minimum(np.minimum(u, v), 1.0 - u - v))
    sel = ok & (t > T_MIN) & (t < t_max)
    return float(margin[sel].min()) if sel.any() else np.inf


def _account(got, ref, soup, o, d, max_flips=MAX_FLIPS):
    """Each differing flag is a ray within EDGE_EPS of a triangle edge."""
    flips = np.nonzero(np.asarray(got) != np.asarray(ref))[0]
    assert len(flips) <= max_flips, f"{len(flips)} flags differ"
    for i in flips:
        near = _near_edge(soup, o[i], d[i])
        assert near < EDGE_EPS, (int(i), near)
    return len(flips)


def _aimed_rays(rng, targets, n, spread, dist):
    """n rays aimed near random targets from `dist` away, unit directions."""
    tg = targets[rng.integers(0, len(targets), n)] + rng.normal(scale=spread, size=(n, 3))
    o = tg + rng.normal(scale=dist, size=(n, 3))
    d = tg - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


TRACE_CASES = ("quad", "soup", "torus", "alpha", "budget_24", "budget_1024", "budget_2048")


def _trace_case(geometry, case):
    """(port BVH, reference BVH, f64 world soup, origins, directions,
    max_steps, alpha_test) of one trace case."""
    rng = np.random.default_rng(TRACE_CASES.index(case) + 1)
    steps, alpha = 1024, False
    if case == "quad":
        nodes, tris = _quad()
        got, ref = shadow.single_blas(nodes, tris), jshadow.single_blas(nodes, tris)
        o = np.concatenate([[[0.0, 0.0, -5.0], [3.0, 3.0, -5.0], [0.0, 0.0, 5.0], [0.5, -0.5, -1.0]],
                            rng.uniform(-1.5, 1.5, (252, 3)) * [1, 1, 0] + [0, 0, -2]]).astype(np.float32)
        d = np.concatenate([np.tile([[0.0, 0.0, 1.0]], (4, 1)), rng.normal(size=(252, 3)) * 0.3 + [0, 0, 1]])
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        return got, ref, tris.astype(np.float64), o, d, steps, alpha
    if case == "soup":
        pts = rng.uniform(-1, 1, size=(900, 3)).astype(np.float32)
        nodes, order = bindings.build_bvh(pts, np.arange(900, dtype=np.uint32))
        tris = pts.reshape(-1, 3, 3)[order]
        got, ref = shadow.single_blas(nodes, tris), jshadow.single_blas(nodes, tris)
        o, d = _aimed_rays(rng, pts.astype(np.float64), 512, 0.3, 3.0)
        return got, ref, tris.astype(np.float64), o, d, steps, alpha
    kind = "alpha" if case == "alpha" else "opaque"
    g, dr, mats, mips = _scene(geometry, kind)
    got, ref = shadow.build_scene_rt(g, dr, mats, mips)[0], jshadow.build_scene_rt(g, dr, mats, mips)[0]
    targets = dr.position[dr.post_pass == 1] if kind == "alpha" else dr.position
    o, d = _aimed_rays(rng, targets.astype(np.float64), 1024, 0.6, 8.0 if kind == "alpha" else 25.0)
    if case.startswith("budget"):
        steps = int(case.split("_")[1])
    return got, ref, _world_soup(g, dr), o, d, steps, case == "alpha"


@pytest.mark.parametrize("case", TRACE_CASES)
def test_trace_matches_reference(geometry, case):
    """trace_any_hit (trace_plain on the CPU) against the reference's on the
    same rays: the quad of tests/test_shadow.py, a 300-triangle soup, the
    two-level scene of 200 torus draws, the alpha-tested any-hit on
    small_alpha_scene's masks (which must change some flags), and the
    budgets 24 (rays cut short: -1 steps, the reference's global budget
    gives the same flags), 1024 and 2048.  Flags exact or each flip
    accounted; steps count the nodes a ray visited."""
    got_bvh, ref_bvh, soup, o, d, steps, alpha = _trace_case(geometry, case)
    occ = shadow.trace_any_hit(got_bvh, torch.from_numpy(o), torch.from_numpy(d), max_steps=steps, alpha_test=alpha)
    n_steps = shadow.trace_plain(got_bvh, torch.from_numpy(o), torch.from_numpy(d), max_steps=steps,
                                 alpha_test=alpha)[1]
    ref = np.asarray(jshadow.trace_any_hit(jax.device_put(ref_bvh), jnp.asarray(o), jnp.asarray(d), max_steps=steps,
                                           alpha_test=alpha))
    occ, n_steps = occ.numpy(), n_steps.numpy()
    _account(occ, ref, soup, o, d)
    assert 0 < ref.sum() < len(ref), "both outcomes"
    assert ((n_steps > 0) & (n_steps <= steps) | (n_steps == -1)).all()
    if case == "quad":
        np.testing.assert_array_equal(occ[:4], [True, False, False, True])
    if case == "budget_24":
        assert (n_steps == -1).sum() > 20 and not occ[n_steps == -1].any(), "cut rays stay unoccluded"
    if case == "alpha":
        opaque = shadow.trace_any_hit(got_bvh, torch.from_numpy(o), torch.from_numpy(d), max_steps=steps).numpy()
        assert (opaque & ~occ).sum() > 5 and not (occ & ~opaque).any(), "the masks let some rays through"


# ------------------------------------------------------------ the kernel's ray order

# (sh, sw) grids of shadow_pass at scale 2: the tests' 256x128, 1920x1080,
# an odd viewer size (width 483, height 271) and a single row
ORDER_GRIDS = [(64, 128), (540, 960), (135, 241), (1, 37)]


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("checkerboard", [True, False], ids=["checkerboard", "full"])
@pytest.mark.parametrize("grid", ORDER_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ray_order_is_a_permutation(grid, checkerboard, parity):
    """ray_order is a permutation of shadow_pass's rays (int32, on the
    asked device, built once per key), in Morton order of their pixels:
    where the grid holds whole 8x8 blocks, the first 32 slots of a
    checkerboard (64 of a full grid) are the rays of the first block."""
    sh, sw = grid
    order = shadow.ray_order(sh, sw, checkerboard, parity, "cpu")
    rows, cols = shadow.ray_pixels(sh, sw, checkerboard, parity, "cpu")
    n = rows.numel()
    assert order.dtype == torch.int32 and tuple(order.shape) == (n,) and order.device.type == "cpu"
    assert torch.equal(torch.sort(order).values, torch.arange(n, dtype=torch.int32))
    assert shadow.ray_order(sh, sw, checkerboard, parity, "cpu") is order
    if sh >= 8 and sw >= 8:
        k = 32 if checkerboard else 64
        first = order[:k].long()
        assert int(rows.reshape(-1)[first].max()) < 8 and int(cols.reshape(-1)[first].max()) < 8


ORDER_CASES = ("torus", "budget_24", "alpha")


@pytest.mark.parametrize("case", ORDER_CASES)
def test_trace_plain_is_order_free(geometry, case):
    """trace_plain on the rays in ray_order's order (a 32x64 checkerboard
    holds the cases' 1,024 rays), its results put back at the ray ids,
    equals trace_plain on the rays in id order, flag for flag and step for
    step: the kernel's order changes no result.  budget_24 has rays out of
    budget (-1), alpha the mask test."""
    got_bvh, _, _, o, d, steps, alpha = _trace_case(geometry, case)
    order = shadow.ray_order(32, 64, True, 1, "cpu").long()
    assert order.numel() == len(o)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    occ, n_steps = shadow.trace_plain(got_bvh, o, d, max_steps=steps, alpha_test=alpha)
    p_occ, p_steps = shadow.trace_plain(got_bvh, o[order], d[order], max_steps=steps, alpha_test=alpha)
    back_occ, back_steps = torch.empty_like(p_occ), torch.empty_like(p_steps)
    back_occ[order], back_steps[order] = p_occ, p_steps
    assert torch.equal(back_occ, occ) and torch.equal(back_steps, n_steps)
    assert 0 < int(occ.sum()) < len(occ)
    if case == "budget_24":
        assert int((n_steps == -1).sum()) > 20


NOT_INT32 = "order must be int32"
NOT_A_PERMUTATION = "order must hold each ray id"
MALFORMED_ORDERS = {
    "int64": (lambda n: torch.arange(n, dtype=torch.int64), NOT_INT32),
    "float": (lambda n: torch.arange(n, dtype=torch.float32), NOT_INT32),
    "short": (lambda n: torch.arange(n - 1, dtype=torch.int32), NOT_INT32),
    "2d": (lambda n: torch.arange(n, dtype=torch.int32).reshape(n // 2, 2), NOT_INT32),
    "list": (lambda n: list(range(n)), NOT_INT32),
    "repeated_id": (lambda n: torch.arange(n, dtype=torch.int32).index_fill_(0, torch.tensor([n - 1]), 0),
                    NOT_A_PERMUTATION),
    "out_of_range": (lambda n: torch.arange(1, n + 1, dtype=torch.int32), NOT_A_PERMUTATION),
    "negative": (lambda n: torch.arange(-1, n - 1, dtype=torch.int32), NOT_A_PERMUTATION),
}


def _quad_rays(n: int = 8):
    nodes, tris = _quad()
    return shadow.single_blas(nodes, tris), torch.zeros((n, 3)), torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)


@pytest.mark.parametrize("kind", list(MALFORMED_ORDERS))
def test_trace_cuda_rejects_malformed_order(kind):
    """trace_cuda raises ValueError on an order that is not int32 [N] on the
    rays' device or does not hold each ray id once (the kernel would leave
    a ray unwalked), before it reaches a device check or the kernel (here
    the rays lie on the CPU, where a well-formed order gets the device
    error)."""
    bvh, o, d = _quad_rays()
    make, message = MALFORMED_ORDERS[kind]
    with pytest.raises(ValueError, match=message):
        shadow.trace_cuda(bvh, o, d, order=make(8))
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        shadow.trace_cuda(bvh, o, d, order=torch.arange(8, dtype=torch.int32))


def test_trace_cuda_rechecks_an_edited_order():
    """The permutation check runs once per order tensor and version: an
    order that passed and was then written in place is checked again."""
    bvh, o, d = _quad_rays()
    order = torch.arange(8, dtype=torch.int32).flip(0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="no kernel for device cpu"):
            shadow.trace_cuda(bvh, o, d, order=order)
    order[3] = order[4]
    with pytest.raises(ValueError, match=NOT_A_PERMUTATION):
        shadow.trace_cuda(bvh, o, d, order=order)


# ------------------------------------------------------------ the pass and the frame


@pytest.mark.parametrize("parity", [0, 1])
def test_checkerboard_fill_matches_reference(parity):
    rng = np.random.default_rng(12 + parity)
    sh_in = np.where(rng.random((40, 60)) < 0.5, 0.0, 1.0).astype(np.float32)
    dep = np.where(rng.random((40, 60)) < 0.1, 0.0, rng.uniform(0.01, 0.5, (40, 60))).astype(np.float32)
    ref = np.asarray(jshadow.checkerboard_fill(jnp.asarray(sh_in), jnp.asarray(dep), parity))
    got = shadow.checkerboard_fill(torch.from_numpy(sh_in), torch.from_numpy(dep), parity).numpy()
    traced = (np.add.outer(np.arange(40), np.arange(60)) + parity) % 2 == 0
    np.testing.assert_array_equal(got[traced], sh_in[traced])
    np.testing.assert_allclose(got, ref, rtol=0, atol=FILL_ATOL)
    assert np.abs(got - sh_in)[~traced].max() > 0.1


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Two chained ray-traced frames of the parity scene, reference and
    port, each from its own BVH (equal bit for bit, as above)."""
    g, ds = parity_scene(tmp_path_factory.mktemp("mesh"))
    draws = cooker.small_scene_draws(g.meshes.count)
    jbvh = jax.device_put(jshadow.build_scene_rt(g, draws)[0])
    tbvh = shadow.build_scene_rt(g, draws)[0]
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=1, bloom=False, shadows=True, raster_interpret=True,
                              **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, bloom=False, shadows=True, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    tds = scene.from_numpy(ds, "cpu")
    jstate = jframe.init_state(ds.num_draws, ds.meshlet_visibility_count)
    tstate = frame.init_state(tds.num_draws, tds.meshlet_visibility_count, "cpu")
    out = []
    for _ in range(2):
        jimg, jfb, jstate, jstats = jframe.render_frame(ds, jstate, jp, jsp, jcfg, bvh=jbvh)
        cap = {}
        timg, tfb, tstate, tstats = frame.render_frame(tds, tstate, tp, tsp, tcfg, bvh=tbvh, capture=cap)
        ref = dict(image=np.asarray(jimg), depth=np.array(jfb.depth), vis=np.asarray(jfb.vis),
                   draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                   stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()})
        dv, vw = frame.state_to_numpy(tstate)
        # the port's term from the reference's depth: what the frame's term
        # would be without the depth's own FMA differences
        term_same = shadow.shadow_pass(torch.from_numpy(ref["depth"]), tbvh, sun_direction=tsp.sun_direction,
                                       inverse_view_projection=tsp.inverse_view_projection, width=W, height=H,
                                       znear=tp.znear)
        got = dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv, vis_words=vw,
                   stats=tstats.to_dict(), term=cap["shadow"].numpy(), term_same=term_same.numpy(), trace=cap["trace"])
        out.append((ref, got))
        tstate = frame.state_from_numpy(ref["draw_vis"], ref["vis_words"], "cpu")
    return dict(frames=out, jbvh=jbvh, tbvh=tbvh, jsp=jsp, tsp=tsp, znear=tp.znear,
                soup=_world_soup(g, draws))


def _dilate(mask, reach_y, reach_x):
    """mask spread by reach pixels along each axis, wrapping as jnp.roll."""
    out = mask.copy()
    for dy in range(-reach_y, reach_y + 1):
        for dx in range(-reach_x, reach_x + 1):
            out |= np.roll(mask, (dy, dx), axis=(0, 1))
    return out


@pytest.mark.parametrize("blur", [False, True], ids=["noblur", "blur"])
@pytest.mark.parametrize("checkerboard", [False, True], ids=["full", "checkerboard"])
def test_shadow_pass_matches_reference(frames, blur, checkerboard):
    """shadow_pass on the reference frame's depth, both packages.  The
    port's traced flags against the reference's walk of the same rays:
    exact or accounted.  Each package reconstructs its own rays (XLA
    contracts the position's product and the norm), so a traced pixel's
    term may differ where its ray passes within EDGE_EPS of an edge; the
    rest of the term as the module docstring states."""
    depth = frames["frames"][1][0]["depth"]
    kw = dict(width=W, height=H, scale=2, checkerboard=checkerboard, blur=blur, znear=frames["znear"])
    ref = np.asarray(jshadow.shadow_pass(jnp.asarray(depth), frames["jbvh"], sun_direction=frames["jsp"].sun_direction,
                                         inverse_view_projection=frames["jsp"].inverse_view_projection, **kw))
    cap = {}
    got = shadow.shadow_pass(torch.from_numpy(depth), frames["tbvh"], sun_direction=frames["tsp"].sun_direction,
                             inverse_view_projection=frames["tsp"].inverse_view_projection, capture=cap, **kw).numpy()
    assert got.shape == (H, W) and np.array_equal(got[::2, ::2], got[1::2, 1::2])
    tr = cap["trace"]
    o, d = tr["origin"].numpy(), tr["direction"].numpy()
    jocc = np.asarray(jshadow.trace_any_hit(frames["jbvh"], jnp.asarray(o), jnp.asarray(d)))
    _account(tr["occluded"].numpy(), jocc, frames["soup"], o, d)

    sh, sw = H // 2, W // 2
    g_half, r_half = got[::2, ::2], ref[::2, ::2]
    valid = depth[::2, ::2] > 0
    assert 50 < (valid & (g_half < 0.5)).sum() and (valid & (g_half > 0.99)).sum() > 50, "shadow and light"
    traced = (np.add.outer(np.arange(sh), np.arange(sw)) % 2 == 0) if checkerboard else np.ones((sh, sw), bool)
    ray_of = np.full((sh, sw), -1)
    ray_of[traced] = np.arange(traced.sum())
    reach = SHADOW_REACH if blur else (1 if checkerboard else 0)
    bad = np.abs(g_half - r_half) > (BLUR_ATOL if blur else FILL_ATOL if checkerboard else 0.0)
    # the traced pixels that may explain them: edge rays within reach
    suspects = traced & valid & _dilate(bad, reach, reach)
    edge = np.zeros_like(traced)
    for y, x in np.argwhere(suspects):
        i = ray_of[y, x]
        edge[y, x] = _near_edge(frames["soup"], o[i], d[i]) < EDGE_EPS
    assert edge.sum() <= MAX_FLIPS
    assert not (bad & ~_dilate(edge, reach, reach)).any(), "a term differs away from every edge ray"



@pytest.mark.parametrize("i", [0, 1])
def test_rt_frame_state_and_stats_exact(frames, i):
    ref, got = frames["frames"][i]
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    assert got["trace"]["max_steps"] == 1024 and not got["trace"]["alpha_test"]


@pytest.mark.parametrize("i", [0, 1])
def test_rt_frame_images_match(frames, i):
    ref, got = frames["frames"][i]
    covered = ref["vis"] != INVALID
    flips = _edge_flips(got["vis"], ref["vis"])
    assert flips.sum() <= 2, f"{flips.sum()} vis ids differ"
    same = covered & ~flips
    err = np.abs(got["depth"] - ref["depth"])[same]
    assert err.max() < 1e-4 and (err > 1e-5).sum() <= 1
    term = got["term"]
    assert (covered & (term > 0.99)).sum() > 500 and (covered & (term < 0.5)).sum() > 500, "shadows and light"
    # each frame's own depth moves its world positions and the blur's depth
    # weights: the term moves at shadow edges (measured: by up to 0.0452,
    # by more than 5e-4 at 1.53% of the pixels)
    moved = np.abs(term - got["term_same"])
    assert moved.max() < 0.05 and (moved > 5e-4).mean() < 0.02, (moved.max(), (moved > 5e-4).mean())
    # the image: where the term did not move, within the opaque frame's
    # limit (tests/test_torch_frame.py), the mean over every pixel too
    # (measured: 11 pixels above 3.7e-3, every one where the term moved;
    # mean 1.70e-5)
    assert np.isfinite(got["image"]).all()
    err = np.abs(got["image"] - ref["image"]).max(axis=-1)
    assert err[~flips & (moved <= 5e-4)].max() <= 3.7e-3 and err[~flips].mean() < 2e-5


def test_frame_config_shadow_fields_match_reference():
    for name in ("shadows", "shadow_scale", "shadow_checkerboard", "shadow_blur", "shadow_quality"):
        assert getattr(frame.FrameConfig(), name) == getattr(jframe.FrameConfig(), name), name


def test_render_frame_takes_the_sun_map_or_the_bvh_not_both():
    cfg = frame.FrameConfig(width=W, height=H, shadows=True, **CAPS)
    with pytest.raises(ValueError, match="not both"):
        frame.render_frame(None, None, None, None, cfg, sun=(None, None, (8, 8)), bvh=shadow.single_blas(*_quad()))


def test_viewer_renders_rt_shadows_on_the_cpu(tmp_path, monkeypatch):
    """`--shadows --device cpu` at 256x128: the BVH of the scene's draws,
    the ray-traced term in the frame, the PNG written."""
    monkeypatch.setattr(render_scene, "VIEWER_CAPACITIES", presets.small_capacities())
    cap = {}
    r = render_scene.run(["--shadows", "--device", "cpu", "--size", f"{W}x{H}", "--draws", "300", "--frames", "1",
                          "--out", str(tmp_path)], capture=cap)
    assert r["cfg"].shadows and r["cfg"].shadow_quality == 0
    assert os.path.getsize(r["paths"][0]) > 0 and cap["trace"]["origin"].shape == ((W // 2) * (H // 2) // 2, 3)
    assert cap["shadow"].shape == (H, W) and float(cap["shadow"].min()) >= 0.0
