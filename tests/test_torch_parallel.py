"""The draw-sharded frame of niagara_tpu_torch (parallel/mesh.py) against
the JAX reference's make_sharded_frame on a 2-device virtual CPU mesh
(kernels in interpret mode, as tests/test_parallel.py runs it), and the
port's sharded frames against each other, on the CPU, torch on one thread.

The reference returns only the image, the stacked state and the summed
stats; its per-device framebuffers are read out of its frame_core through
jax.debug.callback (`_jax_sharded`), and its gdepth and gvis are their
max and min over the exact-depth winners, exact operations.

Against the reference: two chained frames of the parity scene (48 torus
draws, 256x128, opaque, bloom on) and one frame of the alpha parity scene
(textures, sun-map shadows from one packed 256^2 map given to both, bloom
on; each shard uploaded with its materials only, as the reference's
shard_draws does), sharded 2 ways.  Exact: every shard's state and every
summed stat.  gdepth and gvis carry the single frame's float differences
(XLA:CPU's FMA contraction, tests/test_torch_frame.py and
test_torch_shadow.py), and the image adds the G-buffer's quantization
(ops/shade.py::pack_gbuffer): a pre-pack difference of an ulp that
crosses a rounding boundary moves a channel by a whole 1/255 or 1/1023
step (the reference's own note, test_parallel.py:100-105).  So each pixel
whose packed G-buffer differs from the reference's is held to one step
in every field, and the image elsewhere to the single frame's limit.
Measured, opaque frames 1 and 2 (the same numbers): 1 winner flip, on an
edge; depth elsewhere at most 9.44e-5, one pixel above 1e-5, median
relative 2.35e-6 (test_torch_frame.py's numbers); 79 pixels one step
apart in the packed G-buffer, where the image moves by up to 1.95e-2;
elsewhere the image is within 4.04e-7 (limit 1e-6: the quantization
absorbs the sub-step differences), mean 2.99e-6 (limit 4e-6).  The
alpha frame: 9 winner flips, near ties or on an edge (the alpha frame's
count; limit 12); depth at most 9.54e-5, one pixel above 1e-5, median
relative 2.35e-6; 127 pixels apart in the packed G-buffer (limit 140), by
one step in every field but the albedo, which differs by 2 to 14 steps
at 7 pixels (limit 8): checker edges sampled through the uvs of the
unmasked ring's nearly edge-on planes; the image there moves by up to
3.15e-2; elsewhere 2 pixels above 4.8e-3 (limit 3; 7.86e-3 and 8.99e-3
at a shadow edge, where each package's own depth moves the term, as in
test_torch_shadow.py), each pixel's largest channel error averaging
1.33e-5 (limit 2e-5).

Port only: 4 in-process shards against 1 (the alpha scene, textures,
sun map, bloom, two frames): gdepth exact, the 1-shard gdepth equal to
render_frame's depth, the image exact except at pixels whose winning draw
differs (a cross-draw depth tie the id order resolves per sharding; none
here); at this size every shard culls what the single frame culls, while
at 1M draws a shard's sparser pyramid lets through a few draws the single
card culls (chip_smoke.py's "mesh main");
a gloo group of 2 CPU processes against 2 in-process shards, bit for bit;
the glass scene's transmission merge (2 shards against 1); frame_core's
frag_offset; shard_draws against the reference's; pack_gbuffer and
unpack_gbuffer against the reference's, bit for bit."""

import os
import socket
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from niagara_tpu.ops import shade as jshade
from niagara_tpu.ops import sunmap as jsm
from niagara_tpu.parallel import mesh as pmesh
from niagara_tpu.render import frame as jframe
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import cooker, scene
from niagara_tpu_torch.ops import shade, sunmap
from niagara_tpu_torch.parallel import mesh
from niagara_tpu_torch.render import camera, frame, textures
from test_torch_frame import _edge_flips
from test_torch_scene import CAPS, H, N_DRAWS, W, alpha_parity_parts, parity_scene
from test_torch_shadow import MAP, SUN_CAPS
import torch_mesh_rank

INVALID = 0x7FFFFFFF


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU frames run many small ops; under the parallel test
    run's other workers torch's intra-op threads only wait on each other
    (tests/test_torch_rt_shadow.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_sharded(jcfg, stacked, jstate, jp, jsp, n_frames, textures=None, ctx=None):
    """n_frames chained frames of the reference's make_sharded_frame on an
    n-device virtual mesh; per frame its image, stacked state and stats,
    and, read with jax.debug.callback, each device's framebuffer (from its
    frame_core) and packed G-buffer planes (from its pack_gbuffer), merged
    here: depth max, vis min over the exact-depth winners, planes summed."""
    n = stacked.draw_scale.shape[0]
    seen = {}
    core, pack = jframe.frame_core, jshade.pack_gbuffer

    def spy(name, *xs):
        jax.debug.callback(lambda d, *v: seen.__setitem__((name, int(d)), [np.asarray(a) for a in v]),
                           jax.lax.axis_index("draws"), *xs)

    def spied_core(*args, **kw):
        out = core(*args, **kw)
        spy("fb", out[0].depth, out[0].vis)
        return out

    def spied_pack(*args):
        out = pack(*args)
        spy("packed", *out)
        return out

    jm = pmesh.make_mesh(n)
    jframe.frame_core, jshade.pack_gbuffer = spied_core, spied_pack
    try:
        fn = pmesh.make_sharded_frame(jm, jcfg)
        out = []
        for _ in range(n_frames):
            with jm:
                img, jstate, jstats = fn(stacked, jstate, jp, jsp, textures, ctx)
            jax.block_until_ready((img, jstate, jstats))
            jax.effects_barrier()
            depth, vis = (np.stack([seen["fb", d][k] for d in range(n)]) for k in (0, 1))
            gdepth = depth.max(0)
            gvis = np.where((depth == gdepth) & (vis != INVALID), vis, INVALID).min(0)
            packed = [sum(seen["packed", d][k].astype(np.int64) for d in range(n)) & 0xFFFFFFFF for k in (0, 1)]
            out.append(dict(image=np.asarray(img), depth=gdepth, vis=gvis, packed=packed,
                            draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                            stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()}))
    finally:
        jframe.frame_core, jshade.pack_gbuffer = core, pack
    return out


def _packed(cap):
    """A sharded frame's merged G-buffer planes, repacked (unpack then pack
    is the identity on packed words), as u32 values in int64."""
    return [(p.to(torch.int64) & 0xFFFFFFFF).numpy() for p in shade.pack_gbuffer(cap["g0"], cap["g1"], cap["valid"])]


def _port_frames(scenes, refs, tp, tsp, tcfg, **kw):
    """The port's sharded frames beside the reference's `refs`, each frame
    from the reference's previous state (as tests/test_torch_frame.py)."""
    states = mesh.init_sharded_state(scenes)
    out = []
    for ref in refs:
        cap = {}
        img, fb, new, stats = mesh.render_sharded_frame(scenes, states, tp, tsp, tcfg, mesh.InProcess(), capture=cap,
                                                        **kw)
        got = [frame.state_to_numpy(s) for s in new]
        out.append((ref, dict(image=img.numpy(), depth=fb.depth.numpy(), vis=fb.vis.numpy(), packed=_packed(cap),
                              draw_vis=np.stack([g[0] for g in got]), vis_words=np.stack([g[1] for g in got]),
                              stats=stats.to_dict())))
        states = [frame.state_from_numpy(ref["draw_vis"][s], ref["vis_words"][s], "cpu") for s in range(len(scenes))]
    return out


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.fixture(scope="module")
def opaque(mesh_dir):
    g, _ = parity_scene(mesh_dir)
    draws = cooker.small_scene_draws(g.meshes.count)
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=1, bloom=True, raster_interpret=True, **CAPS)
    tcfg = frame.FrameConfig(width=W, height=H, **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), tcfg)
    stacked = pmesh.shard_draws(g, draws, 2)
    refs = _jax_sharded(jcfg, stacked, pmesh.init_sharded_state(stacked, 2), jp, jsp, 2)
    return _port_frames(mesh.shard_draws(g, draws, 2, device="cpu"), refs, tp, tsp, tcfg)


@pytest.fixture(scope="module")
def alpha_sun(mesh_dir):
    """The alpha parity scene's parts, its host texture table, and the
    packed 256^2 sun map of the whole scene (the port's build, given to
    both packages) with each package's sun frame."""
    g, draws, materials, masks, table = alpha_parity_parts(mesh_dir)
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2, shadows=True, **CAPS)
    _, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    rest = types.SimpleNamespace(position=draws.position)
    sf = sunmap.fit_sun_to_draws(tsp.sun_direction, rest, device="cpu")
    full = scene.from_numpy(scene.upload(g, draws, materials, masks, texture_table=table), "cpu")
    static, drop = sunmap.build_static_sun_map(full, sf, batch=16, num_draws=N_DRAWS, map_w=MAP, map_h=MAP,
                                               **SUN_CAPS)
    assert int(drop) == 0
    return dict(g=g, draws=draws, materials=materials, table=table, sf=sf, packed=sunmap.pack_sun_map(static),
                jsf=jsm.fit_sun_to_draws(tsp.sun_direction, rest), cfg=cfg)


@pytest.fixture(scope="module")
def alpha(alpha_sun):
    a = alpha_sun
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=2, bloom=True, shadows=True, raster_interpret=True,
                              **CAPS)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), a["cfg"])
    stacked = pmesh.shard_draws(a["g"], a["draws"], 2, a["materials"])
    refs = _jax_sharded(jcfg, stacked, pmesh.init_sharded_state(stacked, 2), jp, jsp, 1,
                        textures=jax.device_put(a["table"]),
                        ctx=(a["jsf"], jnp.asarray(a["packed"].numpy()), (MAP, MAP)))
    return _port_frames(mesh.shard_draws(a["g"], a["draws"], 2, a["materials"], device="cpu"), refs, tp, tsp,
                        a["cfg"], textures=textures.to_device(a["table"], "cpu"),
                        sun=(a["sf"], a["packed"], (MAP, MAP)))


def _state_and_stats_exact(ref, got):
    np.testing.assert_array_equal(got["draw_vis"], ref["draw_vis"])
    assert got["vis_words"].dtype == ref["vis_words"].dtype == np.uint32
    np.testing.assert_array_equal(got["vis_words"], ref["vis_words"])
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in ref["stats"].items():
        np.testing.assert_array_equal(got["stats"][k], v.astype(np.int64), err_msg=k)
    for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"):
        assert got["stats"][k] == 0, k


# the packed G-buffer's fields: (plane, shift, mask): g0's albedo rgb,
# emissive, g1's octahedral normal and gloss, then bit 30 of p1, valid
PACKED_FIELDS = [(0, s, 255) for s in (0, 8, 16, 24)] + [(1, s, 1023) for s in (0, 10, 20)] + [(1, 30, 1)]


def _compare(ref, got, limits):
    """gdepth, gvis and the image against the reference's, within
    `limits`; returns the measured numbers.  A pixel whose packed G-buffer
    differs from the reference's (in quantization steps of its fields) is
    held to that: at most one step in every field but the albedo's, which
    may step further at `albedo_px` pixels; the image elsewhere to the
    single frame's limit."""
    covered = ref["vis"] != INVALID
    assert 2000 < covered.sum() < covered.size, "objects and background both on screen"
    flips = got["vis"] != ref["vis"]
    tie = np.abs(got["depth"] - ref["depth"]) <= limits["tie_rel"] * ref["depth"]
    _edge_flips(np.where(tie, ref["vis"], got["vis"]), ref["vis"])
    same = covered & ~flips
    np.testing.assert_array_equal(got["depth"][~covered & ~flips], 0.0)
    err = np.abs(got["depth"] - ref["depth"])[same]
    steps = [np.abs(((got["packed"][k] >> s) & m) - ((ref["packed"][k] >> s) & m))[~flips] for k, s, m in PACKED_FIELDS]
    quant = np.zeros_like(flips)
    quant[~flips] = np.max(steps, axis=0) > 0
    ierr = np.abs(got["image"] - ref["image"]).max(-1)
    rest = ~flips & ~quant
    m = dict(flips=int(flips.sum()), depth_max=float(err.max()), depth_1e5=int((err > 1e-5).sum()),
             depth_medrel=float(np.median(err / ref["depth"][same])), quant_px=int(quant.sum()),
             other_steps=int(np.max(steps[3:])), albedo_px=int((np.max(steps[:3], axis=0) > 1).sum()),
             albedo_steps=int(np.max(steps[:3])), quant_image=float(ierr[quant].max(initial=0.0)),
             image_max=float(ierr[rest].max()), image_over=int((ierr[rest] > limits["image_max"]).sum()),
             image_mean=float(ierr[~flips].mean()))
    assert np.isfinite(got["image"]).all()
    assert m["flips"] <= limits["flips"], m
    assert m["depth_max"] < limits["depth_max"] and m["depth_1e5"] <= 1 and m["depth_medrel"] < 3e-6, m
    assert m["other_steps"] <= 1 and m["albedo_px"] <= limits["albedo_px"], m
    assert m["quant_px"] <= limits["quant_px"], m
    assert m["image_over"] <= limits["image_over"] and m["image_mean"] < limits["image_mean"], m
    return m


@pytest.mark.parametrize("i", [0, 1])
def test_sharded_state_and_stats_exact(opaque, i):
    ref, got = opaque[i]
    _state_and_stats_exact(ref, got)
    s = got["stats"]
    if i == 0:
        assert s["early_clusters"] == 0 and s["late_clusters"] > 0
    else:
        assert s["early_clusters"] > 0 and s["late_clusters"] == 0


OPAQUE_LIMITS = dict(flips=2, tie_rel=0.0, depth_max=1e-4, quant_px=90, albedo_px=0, image_max=1e-6, image_over=0,
                     image_mean=4e-6)


@pytest.mark.parametrize("i", [0, 1])
def test_sharded_images_match(opaque, i):
    _compare(*opaque[i], OPAQUE_LIMITS)


def test_sharded_alpha_state_and_stats_exact(alpha):
    ref, got = alpha[0]
    _state_and_stats_exact(ref, got)
    assert got["stats"]["late_clusters"] > 0


ALPHA_LIMITS = dict(flips=12, tie_rel=1.3e-4, depth_max=1e-4, quant_px=140, albedo_px=8, image_max=4.8e-3,
                    image_over=3, image_mean=2e-5)


def test_sharded_alpha_image_matches(alpha):
    _compare(*alpha[0], ALPHA_LIMITS)


@pytest.fixture(scope="module")
def four_and_one(alpha_sun):
    """Two chained frames of the alpha scene (textures, sun map, bloom) as
    4 in-process shards and as 1, each with its winning draws; and
    render_frame of the 1-shard scene on the second frame's state."""
    a = alpha_sun
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), a["cfg"])
    kw = dict(textures=textures.to_device(a["table"], "cpu"), sun=(a["sf"], a["packed"], (MAP, MAP)))
    out = {}
    for n in (4, 1):
        scenes = mesh.shard_draws(a["g"], a["draws"], n, a["materials"], device="cpu")
        states, frames = mesh.init_sharded_state(scenes), []
        for _ in range(2):
            cap, before = {}, states
            img, fb, states, stats = mesh.render_sharded_frame(scenes, states, tp, tsp, a["cfg"], mesh.InProcess(),
                                                               capture=cap, **kw)
            frames.append(dict(image=img, fb=fb, stats=stats.to_dict(),
                               draws=mesh.winning_draws(cap, fb.vis, n, a["cfg"])))
        out[n] = frames
    _, out["render_frame"], _, _ = frame.render_frame(scenes[0], before[0], tp, tsp, a["cfg"], **kw)
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_four_shards_match_one(four_and_one, i):
    """gdepth exact; the image exact wherever the same draw wins; where
    another draw wins, the two tie in depth (gdepth is the same) and the
    sharding's id order picked one of them."""
    four, one = four_and_one[4][i], four_and_one[1][i]
    assert torch.equal(four["fb"].depth, one["fb"].depth)
    covered = one["fb"].vis != INVALID
    assert torch.equal(four["fb"].vis != INVALID, covered) and int(covered.sum()) > 2000
    assert torch.equal(four["draws"] >= 0, covered)
    ties = four["draws"] != one["draws"]
    assert int(ties.sum()) <= 2, int(ties.sum())
    assert torch.equal(four["image"][~ties], one["image"][~ties])
    for s in (four["stats"], one["stats"]):
        assert all(int(s[k]) == 0 for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"))


def test_one_shard_is_render_frame(four_and_one):
    """One shard renders render_frame's depth and visibility buffer."""
    fb = four_and_one["render_frame"]
    assert torch.equal(four_and_one[1][1]["fb"].depth, fb.depth)
    assert torch.equal(four_and_one[1][1]["fb"].vis, fb.vis)


def test_gloo_group_matches_in_process(mesh_dir, tmp_path):
    """Two processes, one shard each, reducing through gloo, against the
    same two shards in this process: image, gdepth, gvis, each rank's state
    and the stats bit for bit.  A rank that fails fails the test."""
    g = cooker.cook_procedural(str(mesh_dir))  # the ranks load the cooker this builds
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(torch_mesh_rank.render_rank, args=(2, port, str(mesh_dir), str(tmp_path), 2), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish in 300 s")
    scenes = mesh.shard_draws(g, cooker.small_scene_draws(g.meshes.count), 2, device="cpu")
    states = mesh.init_sharded_state(scenes)
    cfg = frame.FrameConfig(width=W, height=H, **CAPS)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    for _ in range(2):
        img, fb, states, stats = mesh.render_sharded_frame(scenes, states, tp, tsp, cfg, mesh.InProcess())
    for rank in range(2):
        z = np.load(os.path.join(tmp_path, f"rank{rank}.npz"))
        np.testing.assert_array_equal(z["image"], img.numpy())
        np.testing.assert_array_equal(z["depth"], fb.depth.numpy())
        np.testing.assert_array_equal(z["vis"], fb.vis.numpy())
        for got, want in zip((z["draw_vis"], z["vis_words"]), frame.state_to_numpy(states[rank])):
            np.testing.assert_array_equal(got, want)
        for k, v in stats.to_dict().items():
            np.testing.assert_array_equal(z[f"stats_{k}"], v, err_msg=k)


def _owner_boundary(draws, n):
    """Covered pixels with a covered 8-neighbour whose winning draw another
    shard owns (draw d lives on shard d % n)."""
    owner = torch.where(draws >= 0, draws % n, -1)
    pad = torch.nn.functional.pad(owner, (1, 1, 1, 1), value=-1)
    H, W = owner.shape
    out = torch.zeros(owner.shape, dtype=torch.bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            o = pad[dy:dy + H, dx:dx + W]
            out |= (o >= 0) & (owner >= 0) & (o != owner)
    return out


def test_glass_transmission_merge(mesh_dir):
    """The glass scene (post_passes=3, normal maps) as 2 shards against 1,
    two frames: the merged transmission layer's depth, coverage and valid
    mask exact, gdepth and g0 exact, g1 and the image exact but at
    normal-mapped pixels on an ownership boundary.  There a shard's
    G-buffer takes the screen-space tangent frame's derivatives
    (ops/shade.py::_screen_space_tbn) from its own attributes at the
    neighbour, which hold its local winner there, not the global one:
    the reference's owner shading does the same (mesh.py:122-128).  The
    layer blends in front of the opaque surface."""
    g, d, mats, _, mips = cooker.small_glass_scene(cooker.cook_procedural(str(mesh_dir)))
    cfg = frame.FrameConfig(width=W, height=H, post_passes=3, **CAPS)
    tp, tsp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    tex = textures.to_device(textures.build_texture_table(mips), "cpu")
    out = {}
    for n in (2, 1):
        scenes = mesh.shard_draws(g, d, n, mats, device="cpu")
        states = mesh.init_sharded_state(scenes)
        for _ in range(2):
            cap = {}
            img, fb, states, stats = mesh.render_sharded_frame(scenes, states, tp, tsp, cfg, mesh.InProcess(),
                                                               textures=tex, capture=cap)
        out[n] = dict(image=img, fb=fb, cap=cap, draws=mesh.winning_draws(cap, fb.vis, n, cfg), stats=stats.to_dict())
    two, one = out[2], out[1]
    lay2, lay1 = two["cap"]["layer"], one["cap"]["layer"]
    assert torch.equal(lay2["depth"], lay1["depth"]) and torch.equal(lay2["valid"], lay1["valid"])
    assert torch.equal(lay2["vis"] != INVALID, lay1["vis"] != INVALID)
    assert torch.equal(two["fb"].depth, one["fb"].depth) and torch.equal(two["draws"], one["draws"])
    assert torch.equal(two["cap"]["g0"], one["cap"]["g0"])
    blended = lay1["valid"] & ((lay1["depth"] > one["fb"].depth) | ~one["cap"]["valid"])
    assert int(blended.sum()) > 100
    mat = torch.from_numpy(d.material_index)[two["draws"].clamp(min=0)]
    seam = _owner_boundary(two["draws"], 2) & torch.from_numpy(mats["textures"][:, 1] >= 0)[mat]
    g1_diff = (two["cap"]["g1"] != one["cap"]["g1"]).any(-1)
    image_diff = (two["image"] != one["image"]).any(-1)
    assert not bool((g1_diff & ~seam).any()) and not bool((image_diff & ~seam).any())
    # measured: 454 seam pixels, 186 with another g1, 127 with another colour
    assert 0 < int(image_diff.sum()) <= int(g1_diff.sum()) < int(seam.sum()) < 1000
    assert all(int(two["stats"][k]) == 0 for k in ("cmd_dropped", "cluster_dropped", "tri_dropped", "pair_dropped"))


@pytest.fixture(scope="module")
def offsets(alpha_sun):
    """frame_core on the alpha scene's second frame (an early and a late
    pass) without an offset, with 0 and with a nonzero one."""
    a = alpha_sun
    cfg = frame.FrameConfig(width=W, height=H, post_passes=2, **CAPS)
    tp, _ = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    sc = mesh.shard_draws(a["g"], a["draws"], 1, a["materials"], device="cpu")[0]
    state = frame.frame_core(sc, mesh.init_sharded_state([sc])[0], tp, cfg)[1]
    k = 3 * mesh.frag_stride(cfg) + 5
    return dict(cfg=cfg, k=k, args=(sc, state, tp, cfg), base=frame.frame_core(sc, state, tp, cfg),
                zero=frame.frame_core(sc, state, tp, cfg, frag_offset=0),
                shifted=frame.frame_core(sc, state, tp, cfg, frag_offset=k))


def _same_frame(a, b):
    """frame_core outputs equal in everything but the vis ids."""
    assert torch.equal(a[0].depth, b[0].depth) and torch.equal(a[3], b[3])
    assert torch.equal(a[1].draw_vis, b[1].draw_vis) and torch.equal(a[1].vis_words, b[1].vis_words)
    sa, sb = a[2].to_dict(), b[2].to_dict()
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)


def test_frag_offset_zero_is_the_default(offsets):
    base, zero = offsets["base"], offsets["zero"]
    _same_frame(base, zero)
    assert torch.equal(base[0].vis, zero[0].vis)
    covered = base[0].vis != INVALID
    s = base[2].to_dict()
    assert int(s["early_clusters"]) > 0 and int(s["late_clusters"]) > 0
    assert int(base[0].vis[covered].max()) < frame.frag_span(offsets["cfg"])


def test_frag_offset_shifts_every_id(offsets):
    base, shifted, k = offsets["base"], offsets["shifted"], offsets["k"]
    _same_frame(base, shifted)
    covered = base[0].vis != INVALID
    assert torch.equal(shifted[0].vis != INVALID, covered)
    assert torch.equal(shifted[0].vis[covered], base[0].vis[covered] + k)
    # both passes' ids moved: the early pass's below tri_capacity, the late group's above
    ids = base[0].vis[covered]
    assert bool((ids < offsets["cfg"].tri_capacity).any()) and bool((ids >= offsets["cfg"].tri_capacity).any())


@pytest.mark.parametrize("offset", [-1, INVALID])
def test_frag_offset_out_of_range_raises(offsets, offset):
    with pytest.raises(ValueError, match="frag_offset"):
        frame.frame_core(*offsets["args"], frag_offset=offset - (frame.frag_span(offsets["cfg"]) - 1 if offset > 0 else 0))


@pytest.mark.parametrize("post_passes", [1, 2, 3])
def test_frag_stride_and_bytes_match_reference(post_passes):
    """frag_stride is the reference's per-device stride (mesh.py:92-93)
    from the port's own FrameConfig properties; allreduce_bytes_per_frame
    is the reference's."""
    caps = dict(CAPS, late_tri_capacity=CAPS["tri_capacity"] // 2)
    jcfg = jframe.FrameConfig(width=W, height=H, post_passes=post_passes, **caps)
    tcfg = frame.FrameConfig(width=W, height=H, post_passes=post_passes, **caps)
    late_blocks = max(len(jcfg.late_class_groups), jcfg.post_passes)
    assert mesh.frag_stride(tcfg) == jcfg.tri_capacity + late_blocks * jcfg.late_tri_cap
    for t in (False, True):
        assert mesh.allreduce_bytes_per_frame(tcfg, t) == pmesh.allreduce_bytes_per_frame(jcfg, t)


def test_shard_draws_matches_reference(alpha_sun):
    """Every shard's layout equals the reference's stacked shard, array for
    array, with the common (largest) visibility count."""
    a = alpha_sun
    ours = mesh.shard_draws(a["g"], a["draws"], 4, a["materials"], device="cpu")
    ref = pmesh.shard_draws(a["g"], a["draws"], 4, a["materials"])
    for s, sc in enumerate(ours):
        for name in scene._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(sc, name).numpy(), getattr(ref, name)[s], err_msg=name)
        assert sc.meshlet_visibility_count == ref.meshlet_visibility_count
        assert not sc.has_alpha_masks and not sc.has_texture_meta
    assert [sc.num_draws for sc in ours] == [N_DRAWS // 4] * 4


def test_shard_draws_needs_equal_shards(alpha_sun):
    with pytest.raises(ValueError, match="equal shards"):
        mesh.shard_draws(alpha_sun["g"], alpha_sun["draws"], 5, device="cpu")


def test_make_mesh_raises_past_the_devices():
    with pytest.raises(RuntimeError, match="make_mesh"):
        mesh.make_mesh(torch.cuda.device_count() + 1)


def _planes(seed):
    rng = np.random.default_rng(seed)
    g0, g1 = rng.random((64, 128, 4), np.float32), rng.random((64, 128, 4), np.float32)
    g1[..., 3] = 0.0  # unused channel, zero by construction
    # both ends, rounding boundaries (x.5 steps) and out-of-range values
    g0[:4] = np.float32([0.0, 1.0, 0.5 / 255, 1.25])[:, None, None]
    g0[4, :, 0] = (np.arange(128) + 0.5) / 255
    g1[4, :, 1] = (np.arange(128) * 8 + 0.5) / 1023
    g1[5] = -0.5
    return g0, g1, rng.random((64, 128)) < 0.7


def test_pack_gbuffer_matches_reference():
    g0, g1, valid = _planes(3)
    jp = jshade.pack_gbuffer(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(valid))
    tp = shade.pack_gbuffer(torch.from_numpy(g0), torch.from_numpy(g1), torch.from_numpy(valid))
    for a, b in zip(jp, tp):
        assert b.dtype == torch.int32 and np.asarray(a).dtype == np.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (tp[0].numpy() < 0).any(), "p0 words with bit 31 set wrap to negative i32"
    assert (tp[0].numpy()[~valid] == 0).all() and (tp[1].numpy()[~valid] == 0).all()
    for a, b in zip(jshade.unpack_gbuffer(*jp), shade.unpack_gbuffer(*tp)):
        assert np.asarray(a).dtype == b.numpy().dtype and np.asarray(a).tobytes() == b.numpy().tobytes()


def test_packed_owner_planes_sum_to_their_union():
    """Disjoint owner planes summed (InProcess.sum, as the sharded frame's
    merge) equal the packing of the union bit for bit (test_parallel.py
    :232-262); unpacking restores valid exactly and each channel within
    half a step."""
    g0, g1, valid = (torch.from_numpy(x) for x in _planes(5))
    owner = torch.from_numpy(np.random.default_rng(6).integers(0, 3, valid.shape))
    parts = [shade.pack_gbuffer(g0, g1, valid & (owner == s)) for s in range(3)]
    whole = shade.pack_gbuffer(g0, g1, valid)
    coll = mesh.InProcess()
    for k in (0, 1):
        assert torch.equal(coll.sum([p[k] for p in parts]), whole[k])
    r0, r1, rvalid = shade.unpack_gbuffer(*whole)
    assert torch.equal(rvalid, valid)
    v = valid & (g0[..., 0] >= 0) & (g0 <= 1).all(-1) & (g1[..., :3] >= 0).all(-1)
    assert float((r0[v] - g0[v]).abs().max()) <= 0.5 / 255 + 1e-7
    assert float((r1[v][:, :3] - g1[v][:, :3]).abs().max()) <= 0.5 / 1023 + 1e-7
