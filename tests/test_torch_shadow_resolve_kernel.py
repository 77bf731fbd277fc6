"""The sun-map resolve kernel (csrc/shadowmap.cu) against its plain twin.

On the card (marked `cuda`, skipped where there is no GPU; there, without
tests/conftest.py: `python -m pytest tests/test_torch_shadow_resolve_kernel.py
-m cuda --noconftest -q`): ops/sunmap.py shadow_resolve_cuda against
shadow_map_plain on the same inputs, the term bit for bit and the kernel's
count of tested texels equal to the half-resolution depth's texels above 0,
on seeded depths (zeros, values near the 1e-20 guard, positions far past
the map's border) and seeded maps, at 1920x1080 and at sizes no tile
divides (the wrap at every edge, grids narrower than the blur's reach),
scale 1 and 2, blur on and off; shadow_map_pass on CUDA tensors launches
the kernel once (packing the map first when given no table); the small
opaque frame rendered with its sun map (render/parity.py
replay_shadow_resolve; the gate replays the alpha frame's too).

On the CPU (tier-1): shadow_map_pass takes the plain twin for CPU tensors,
equal bit for bit to the code it replaced (written out below), packed and
unpacked, blur on and off, scale 1 and 2, and launches nothing; the kernel
wrapper refuses a wrong dtype, shape, a non-contiguous input and CPU
tensors; the count "sun-map resolve texels" reaches a StageTimer, directly
and through render_frame."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from niagara_tpu_torch import _build, cooker, scene
from niagara_tpu_torch.ops import shadow, sunmap
from niagara_tpu_torch.render import camera, frame, parity, presets
from niagara_tpu_torch.utils.profiling import StageTimer

MAP_H, MAP_W = 96, 128
COUNTER = "sun-map resolve texels"


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")


def _inputs(width: int, height: int, seed: int, device="cpu"):
    """Seeded resolve inputs on `device`: reverse-Z depth [height, width]
    (a tenth 0, a fiftieth at or near the 1e-20 guard, the rest over
    1e-4..1, so positions reach from the near plane to far past the map),
    a sun frame fit to a 120-unit box around the camera (the default
    camera's frustum leaves it), a seeded map with its packed table, and
    the camera's inverse view-projection."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(1e-4, 1.0, (height, width)).astype(np.float32)
    pick = rng.uniform(0.0, 1.0, (height, width))
    d[pick < 0.1] = 0.0
    tiny = (pick >= 0.1) & (pick < 0.12)
    d[tiny] = rng.choice(np.array([1e-20, 5e-21, 2e-20, 1.5e-20, 1e-30], np.float32), int(tiny.sum()))
    smap = rng.uniform(0.0, 1.0, (MAP_H, MAP_W)).astype(np.float32)
    smap[rng.uniform(0.0, 1.0, smap.shape) < 0.2] = 0.0
    sf = sunmap.fit_sun(np.array([-0.3, -1.0, -0.2], np.float32), (-60.0, -60.0, -60.0), (60.0, 60.0, 60.0),
                        device=device)
    cfg = frame.FrameConfig(width=width, height=height, **presets.small_capacities())
    _, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    smap_t = torch.from_numpy(smap).to(device)
    return dict(depth=torch.from_numpy(d).to(device), sf=sf, sun_map=smap_t, packed=sunmap.pack_sun_map(smap_t),
                ivp=sp.inverse_view_projection)


def _replaced(depth, sf, sun_map, *, inverse_view_projection, width, height, bias_texels=1.5, scale=2, packed=None,
              map_shape=None, blur=False, znear=0.1):
    """shadow_map_pass as it was before the kernel, line for line."""
    d_small, wpos = shadow.world_positions(depth, inverse_view_projection, width, height, scale)
    if packed is not None:
        mh, mw = map_shape if map_shape is not None else sun_map.shape
        term = sunmap.sample_shadow_packed(packed, mh, mw, sf, wpos, bias_texels=bias_texels)
    else:
        term = sunmap.sample_shadow(sun_map, sf, wpos, bias_texels=bias_texels)
    term = torch.where(d_small > 0.0, term, 1.0)
    if blur:
        term = shadow.shadow_blur(term, d_small, znear)
    if scale == 1:
        return term
    return term.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)[:height, :width]


def _call(x, width, height, *, packed: bool, **kw):
    """shadow_map_pass's arguments for inputs `x`, from the table or the map."""
    args = (x["depth"], x["sf"], None if packed else x["sun_map"])
    return args, dict(inverse_view_projection=x["ivp"], width=width, height=height,
                      packed=x["packed"] if packed else None, map_shape=(MAP_H, MAP_W) if packed else None, **kw)


def _tested(depth, width, height, scale):
    return int((depth[::scale, ::scale][:height // scale, :width // scale] > 0.0).sum())


# --------------------------------------------------------------- CPU (tier-1)


def test_shadow_resolve_launch_counter_and_source_exist():
    assert "shadow_resolve" in _build.LAUNCHES and "shadowmap.cu" in _build.SOURCES
    assert "shadow_resolve_launch" in _build._SIGNATURES
    assert _build.SHADOW_TAPS == shadow.SHADOW_BLUR_KERNEL


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("blur", [False, True], ids=["no_blur", "blur"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_cpu_tensors_take_the_code_they_replace(packed, blur, scale):
    """On CPU tensors shadow_map_pass launches nothing and equals the code
    it replaced (and shadow_map_plain) bit for bit, at a size no tile
    divides; the blur changes the term, and it is neither all lit nor all
    dark."""
    width, height = 150, 86
    x = _inputs(width, height, 11)
    args, kw = _call(x, width, height, packed=packed, scale=scale, blur=blur)
    before = dict(_build.LAUNCHES)
    got = sunmap.shadow_map_pass(*args, **kw)
    assert dict(_build.LAUNCHES) == before
    want = _replaced(*args, **kw)
    parity.same_bits(got, want, "shadow_map_pass against the code it replaced")
    parity.same_bits(got, sunmap.shadow_map_plain(*args, **kw), "shadow_map_pass against shadow_map_plain")
    assert tuple(got.shape) == (height // scale * scale, width // scale * scale)
    assert bool((got < 0.5).any()) and bool((got > 0.5).any())
    if blur:
        assert not torch.equal(got, _replaced(*args, **dict(kw, blur=False)))


def test_wrapper_refuses_wrong_inputs():
    """shadow_resolve_cuda refuses a wrong dtype, a wrong shape, a
    non-contiguous input and, with every input right, CPU tensors."""
    width, height = 64, 32
    x = _inputs(width, height, 5)
    kw = dict(inverse_view_projection=x["ivp"], width=width, height=height)
    map_shape = (MAP_H, MAP_W)
    cases = [
        ("depth", x["depth"].double(), "depth: expected a contiguous float32"),
        ("depth", x["depth"][:, :-1], r"depth: expected a contiguous float32 \(32, 64\)"),
        ("depth", torch.zeros(width, height).t(), "depth: expected a contiguous"),
        ("packed", x["packed"][:, :3], "packed: expected"),
        ("packed", x["packed"].half(), "packed: expected"),
        ("packed", x["packed"].t().contiguous().t(), "packed: expected a contiguous"),
    ]
    for name, bad, match in cases:
        args = dict(dict(depth=x["depth"], packed=x["packed"]), **{name: bad})
        with pytest.raises(ValueError, match=match):
            sunmap.shadow_resolve_cuda(args["depth"], x["sf"], args["packed"], map_shape, **kw)
    bad_sf = dict(x["sf"], rows=x["sf"]["rows"].t())
    with pytest.raises(ValueError, match="sun rows: expected a contiguous"):
        sunmap.shadow_resolve_cuda(x["depth"], bad_sf, x["packed"], map_shape, **kw)
    with pytest.raises(ValueError, match="has no texel"):
        sunmap.shadow_resolve_cuda(x["depth"], x["sf"], x["packed"], map_shape, **dict(kw, width=1))
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        sunmap.shadow_resolve_cuda(x["depth"], x["sf"], x["packed"], map_shape, **kw)


@pytest.mark.parametrize("scale", [1, 2])
def test_counter_reaches_stage_timer(scale):
    """shadow_map_pass with a StageTimer counts the texels tested against
    the map against all texels; without one it counts nothing, and the
    term is the same."""
    width, height = 150, 86
    x = _inputs(width, height, 12)
    args, kw = _call(x, width, height, packed=True, scale=scale, blur=True)
    timer = StageTimer("cpu")
    timer.begin()
    got = sunmap.shadow_map_pass(*args, **kw, stages=timer)
    f = timer.resolve()[0]
    n = _tested(x["depth"], width, height, scale)
    assert 0 < n < (height // scale) * (width // scale)
    assert f["counters"] == {COUNTER: ((n,), ((height // scale) * (width // scale),))}
    parity.same_bits(got, sunmap.shadow_map_pass(*args, **kw), "the term with and without the timer")


def _small_sun_frame(geometry, device, stages=None):
    """The small opaque scene with its 256x256 sun map, two shadowed frames
    from a cold state (the second captured, and with `stages`): (cfg,
    params, shade params, capture, sun)."""
    draws = cooker.small_scene_draws(geometry.meshes.count)
    sc = scene.from_numpy(scene.upload(geometry, draws), device)
    cfg = frame.FrameConfig(width=256, height=128, shadows=True, **presets.small_capacities())
    params, sp = frame.make_frame_inputs(camera.Camera(), camera.RenderSettings(), cfg)
    sf = sunmap.fit_sun_to_draws(sp.sun_direction, draws, device=device)
    static, drop = sunmap.build_static_sun_map(sc, sf, map_w=parity.SUN_MAP, map_h=parity.SUN_MAP, **parity.SUN_CAPS)
    assert int(drop) == 0
    sun = (sf, sunmap.pack_sun_map(static), (parity.SUN_MAP, parity.SUN_MAP))
    state = frame.init_state(sc.num_draws, sc.meshlet_visibility_count, device)
    state = frame.render_frame(sc, state, params, sp, cfg, sun=sun)[2]
    if stages is not None:
        stages.begin()
    cap = {}
    frame.render_frame(sc, state, params, sp, cfg, sun=sun, capture=cap, stages=stages)
    return cfg, params, sp, cap, sun


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    return cooker.cook_procedural(str(tmp_path_factory.mktemp("shadow_resolve")))


def test_counter_through_render_frame(geometry):
    """render_frame with the sun map and a StageTimer: composite_frame
    passes the timer on, and the count is the frame's half-resolution
    depth's texels above 0 against all of them."""
    timer = StageTimer("cpu")
    cfg, _, _, cap, _ = _small_sun_frame(geometry, "cpu", stages=timer)
    f = timer.resolve()[0]
    n = _tested(cap["depth"], cfg.width, cfg.height, 2)
    assert n > 100
    assert f["counters"][COUNTER] == ((n,), ((cfg.height // 2) * (cfg.width // 2),))
    assert "sun-map resolve+blur" in [name for name, *_ in f["stages"]]


# --------------------------------------------------------------- the card


def _hold(x, width, height, *, scale, blur, packed=True):
    """shadow_resolve_cuda against shadow_map_plain on inputs `x` (CUDA):
    one launch, the term bit for bit, the count equal to the depth's
    texels above 0.  Returns the term."""
    args, kw = _call(x, width, height, packed=True, scale=scale, blur=blur)
    before = _build.LAUNCHES["shadow_resolve"]
    if packed:
        got, tested = sunmap.shadow_resolve_cuda(x["depth"], x["sf"], x["packed"], (MAP_H, MAP_W),
                                                 inverse_view_projection=x["ivp"], width=width, height=height,
                                                 scale=scale, blur=blur)
    else:  # through the dispatch, from the map: it packs first
        timer = StageTimer("cuda")
        timer.begin()
        uargs, ukw = _call(x, width, height, packed=False, scale=scale, blur=blur)
        got = sunmap.shadow_map_pass(*uargs, **ukw, stages=timer)
        tested = torch.tensor(timer.resolve()[0]["counters"][COUNTER][0])
    assert _build.LAUNCHES["shadow_resolve"] == before + 1
    parity.same_bits(got, sunmap.shadow_map_plain(*args, **kw), "shadow_resolve_cuda against shadow_map_plain")
    assert int(tested.reshape(-1)[0]) == _tested(x["depth"], width, height, scale)
    return got


SIZES = [(1920, 1080), (250, 130), (251, 131), (77, 45), (30, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("blur", [True, False], ids=["blur", "no_blur"])
@pytest.mark.parametrize("scale", [2, 1])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_kernel_matches_plain_on_seeded_depths(size, scale, blur):
    _need_cuda()
    width, height = size
    x = _inputs(width, height, 1000 + width + scale, "cuda")
    got = _hold(x, width, height, scale=scale, blur=blur)
    # a texel at the 1e-20 guard lands ~1e20 units out, past int64's range
    # (its term NaN, in both); on a grid the blur reaches across, it
    # spreads to every texel, twin and kernel alike
    if not blur or min(width // scale, height // scale) > 2 * shadow.SHADOW_BLUR_KERNEL:
        assert bool((got < 0.5).any()) and bool((got > 0.5).any())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1920, 1080), (251, 131)], ids=["1920x1080", "251x131"])
def test_dispatch_launches_the_kernel_from_the_map(size):
    """shadow_map_pass on CUDA tensors without a table packs the map and
    launches the kernel once: the packed twin's term, and the count
    through the StageTimer."""
    _need_cuda()
    width, height = size
    x = _inputs(width, height, 77, "cuda")
    _hold(x, width, height, scale=2, blur=True, packed=False)


@pytest.mark.cuda
def test_kernel_on_the_small_frames(geometry):
    """The small opaque frame rendered on the card with its sun map: one
    launch a frame's resolve, and the replay bit for bit against the twin
    and the frame's own term."""
    _need_cuda()
    before = _build.LAUNCHES["shadow_resolve"]
    cfg, params, sp, cap, sun = _small_sun_frame(geometry, "cuda")
    assert _build.LAUNCHES["shadow_resolve"] - before == 2
    calls = parity.replay_shadow_resolve(cap, sun, sp.inverse_view_projection, cfg, params.znear)
    assert [c["name"] for c in calls] == ["shadow_resolve"]
    assert bool((cap["shadow"] < 1.0).any())
