"""The port's entry points (niagara_tpu_torch/entry.py) against the JAX
package's (__graft_entry__.py), on the CPU, torch on one thread.

* `entry(device="cpu")`: two chained frames against the reference's own
  `entry()` (its FrameConfig and draw placement, kernels in interpret
  mode) with its cook pointed at the port's procedural torus, the
  reference's render_frame outputs read through a spy.  The port's
  second frame starts from the reference's first-frame state (as
  tests/test_torch_frame.py).  Exact: FrameState, every FrameStats field
  and the visibility buffer (no winner differs).  Depth and the image
  carry tests/test_torch_frame.py's float differences (XLA:CPU's FMA
  contraction of the depth planes) and its limits: depth at most
  1.97e-5 apart, one pixel above 1e-5, median relative 1.90e-6 (limits
  1e-4, one pixel, 3e-6), so not within one ulp; the image within 5.1e-4
  but at one pixel, which moves by 3.92e-3, one step of the G-buffer's
  8-bit albedo (1/255), mean 7.5e-7 (limits: 3.7e-3 but at 2 pixels,
  each within 4e-3; mean 2e-6).  Both frames give the same numbers.
* `dryrun_multichip(2, device="cpu")`: its sharded frame against the
  reference's make_sharded_frame on a 2-device virtual CPU mesh with
  __graft_entry__.py's dry-run configuration, through
  tests/test_torch_parallel.py's harness and limits.  Exact: each
  shard's state, the summed stats, the winners.  Measured: gdepth within
  5.48e-6, 29 pixels one quantization step apart in the packed G-buffer
  (limit 40), the image elsewhere within 2.98e-7 (limit 1e-6).
* Without a card and without device="cpu" both entry points raise, and
  `python -m niagara_tpu_torch.entry` exits nonzero."""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from niagara_tpu.cooker import cook as jcook
from niagara_tpu.parallel import mesh as pmesh
from niagara_tpu.render import frame as jframe
from niagara_tpu.render.camera import Camera, RenderSettings
from niagara_tpu_torch import cooker, entry
from niagara_tpu_torch.parallel import mesh
from niagara_tpu_torch.render import frame
from test_torch_parallel import OPAQUE_LIMITS, _compare, _jax_sharded, _packed, _state_and_stats_exact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INVALID = 0x7FFFFFFF
DRYRUN_SHARDS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small ops: under the parallel test run torch's intra-op
    threads only wait on each other (tests/test_torch_rt_shadow.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spy(mp, module, seen):
    """module.render_frame recording its outputs in `seen`: each entry's
    fn returns only the image and state."""
    render_frame = module.render_frame

    def spy(*args, **kw):
        seen.append(render_frame(*args, **kw))
        return seen[-1]

    mp.setattr(module, "render_frame", spy)


@pytest.fixture(scope="module")
def entry_frames(tmp_path_factory):
    """Two chained frames of each package's entry(): (reference, port)."""
    d = str(tmp_path_factory.mktemp("mesh"))
    obj = cooker.procedural_obj(d)
    cook_or_load = jcook.cook_or_load
    jseen, tseen, out = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcook, "cook_or_load", lambda paths, cache_dir=None, build_lods=True:
                   cook_or_load([obj], cache_dir=d, build_lods=build_lods))
        _spy(mp, jframe, jseen)
        _spy(mp, frame, tseen)
        jfn, (js, jstate, jp, jsp) = ge.entry()
        tfn, (ts, tstate, tp, tsp) = entry.entry(device="cpu")
        assert ts.draw_scale.device.type == tstate.draw_vis.device.type == "cpu"
        for _ in range(2):
            jimg, jstate = jfn(js, jstate, jp, jsp)
            timg, tstate = tfn(ts, tstate, tp, tsp)
            (_, jfb, _, jstats), (_, tfb, _, tstats) = jseen[-1], tseen[-1]
            dv, vw = frame.state_to_numpy(tstate)
            out.append((dict(image=np.asarray(jimg), depth=np.asarray(jfb.depth), vis=np.asarray(jfb.vis),
                             draw_vis=np.asarray(jstate.draw_vis), vis_words=np.asarray(jstate.vis_words),
                             stats={k: np.asarray(v) for k, v in vars(jax.device_get(jstats)).items()}),
                        dict(image=timg.numpy(), depth=tfb.depth.numpy(), vis=tfb.vis.numpy(), draw_vis=dv,
                             vis_words=vw, stats=tstats.to_dict())))
            tstate = frame.state_from_numpy(out[-1][0]["draw_vis"], out[-1][0]["vis_words"], "cpu")
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_entry_state_stats_and_vis_exact(entry_frames, i):
    ref, got = entry_frames[i]
    _state_and_stats_exact(ref, got)
    s = got["stats"]
    assert (s["early_clusters"] == 0) == (i == 0) and s["visible_draws"] > 0
    np.testing.assert_array_equal(got["vis"], ref["vis"])


@pytest.mark.parametrize("i", [0, 1])
def test_entry_depth_and_image_match(entry_frames, i):
    ref, got = entry_frames[i]
    covered = ref["vis"] != INVALID
    assert 2000 < covered.sum() < covered.size, "objects and background both on screen"
    np.testing.assert_array_equal(got["depth"][~covered], 0.0)
    err = np.abs(got["depth"] - ref["depth"])[covered]
    assert err.max() < 1e-4 and (err > 1e-5).sum() <= 1
    assert np.median(err / ref["depth"][covered]) < 3e-6
    assert np.isfinite(got["image"]).all() and got["image"].shape == (256, 256, 3)
    ierr = np.abs(got["image"] - ref["image"]).max(-1)
    assert (ierr > 3.7e-3).sum() <= 2 and ierr.max() < 4e-3
    assert np.abs(got["image"] - ref["image"]).mean() < 2e-6


@pytest.fixture(scope="module")
def dryrun():
    """The reference's dry-run frame (__graft_entry__.py:115-146: 16 draws,
    every fourth alpha, 128x64) through make_sharded_frame on 2 virtual CPU
    devices, and dryrun_multichip(2, device="cpu") with its capture."""
    g, draws = entry._small_scene(8 * DRYRUN_SHARDS)
    draws.post_pass[::4] = 1
    jcfg = jframe.FrameConfig(width=128, height=64, max_groups=8, cmd_capacity=256, cluster_capacity=512,
                              small_capacity=1 << 12, big_capacity=64, pair_capacity=1 << 12, post_passes=2,
                              raster_interpret=True)
    jp, jsp = jframe.make_frame_inputs(Camera(), RenderSettings(), jcfg)
    stacked = pmesh.shard_draws(g, draws, DRYRUN_SHARDS)
    (ref,) = _jax_sharded(jcfg, stacked, pmesh.init_sharded_state(stacked, DRYRUN_SHARDS), jp, jsp, 1)
    cap = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "render_sharded_frame", functools.partial(mesh.render_sharded_frame, capture=cap))
        out = entry.dryrun_multichip(DRYRUN_SHARDS, device="cpu")
    got = [frame.state_to_numpy(s) for s in out["states"]]
    return ref, dict(image=out["image"].numpy(), depth=out["fb"].depth.numpy(), vis=out["fb"].vis.numpy(),
                     packed=_packed(cap), draw_vis=np.stack([s[0] for s in got]),
                     vis_words=np.stack([s[1] for s in got]), stats=out["stats"].to_dict())


def test_dryrun_state_and_stats_exact(dryrun):
    ref, got = dryrun
    _state_and_stats_exact(ref, got)
    assert got["stats"]["late_clusters"] > 0
    np.testing.assert_array_equal(got["vis"], ref["vis"])


def test_dryrun_image_matches(dryrun):
    ref, got = dryrun
    assert got["image"].shape == (64, 128, 3)
    _compare(ref, got, dict(OPAQUE_LIMITS, quant_px=40))


def test_dryrun_prints_its_line(capsys):
    out = entry.dryrun_multichip(1, device="cpu")
    s = out["stats"]
    assert capsys.readouterr().out == (f"dryrun_multichip(1): ok; visible_draws={int(s.visible_draws)} "
                                       f"clusters={int(s.late_clusters)}\n")


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no GPU"):
        entry.dryrun_multichip(2)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for args in ([], ["dryrun", "2"]):
        proc = subprocess.run([sys.executable, "-m", "niagara_tpu_torch.entry", *args], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "no GPU" in proc.stderr and "ok" not in proc.stdout
